// Kernel J: Forward and Backward of listed pairs in one launch -> Forward
// score, match occupancy, begin and end posteriors.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_posterior (the first
// stage of PairDomains).  For each row (sequence, profile) the block runs
//
//   pass A: the rescaled Forward of forward_step.cuh over the sequence,
//     recording after each residue the rescaled N, B, J, C, E and the
//     running log scale (kernels.py:1816-1839), and the score
//     log(C * move + 1e-38) + ls after the last residue (an empty sequence
//     scores -1e30);
//   pass B: the rescaled Backward of backward_step.cuh from the last
//     residue down, combining at every residue o the Backward specials
//     with the recorded Forward values of o and o-1 (emit_posterior,
//     kernels.py:1850-1875) into mocc(o), pB(o) and, where asked, pE(o),
//
// and writes post[0] = mocc, post[1] = pB, post[2] = pE as [rows][stride],
// zero from the row's length to the stride.  The six Forward trajectories
// never leave the block: they live in shared memory between the passes (the
// TPU kernel kept them in VMEM scratch), so a launch needs
// (10 * width + 1 + 6 * stride) * 4 bytes of dynamic shared memory a block,
// which the wrapper holds under the 227 KB a block may opt into.
//
// Bound on the H100: the per-residue dependency chains of both passes (two
// barriers a residue each, a scan and a sum across nodes); ~19 + 24 float
// operations and two emission reads per DP cell.
//
// Design: one block per pair, CHUNK nodes a thread; transitions, the node
// mask, the Backward delete-chain basis U and the trajectories in shared
// memory; emission rows read by residue index from the bank tensor.  Thread
// 0 records the trajectories and is the one that reads them back, so no
// barrier separates the passes beyond those of the steps themselves.  The
// TPU kernel's (St, 8) grid of C gathered profile rows has no counterpart.
#include "backward_step.cuh"

using namespace gecco;

namespace {

constexpr int N_TRAJ = 6;  // fN, fB, fJ, fC, fE, flog

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
pair_posterior_kernel(RowArgs a, int n_post, float* __restrict__ score_out,
                      float* __restrict__ post) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float smem[];  // trans [8][W], nm [W], U [W + 1], traj [6][stride]
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ BackwardScratch<THREADS> bsh;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* U = nm + WIDTH;
    float* traj = U + WIDTH + 1;
    float* fN = traj;
    float* fB = traj + a.stride;
    float* fJ = traj + 2 * a.stride;
    float* fC = traj + 3 * a.stride;
    float* fE = traj + 4 * a.stride;
    float* flog = traj + 5 * a.stride;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
    __syncthreads();

    // pass A: Forward, the trajectories into shared memory
    float score = NEG;
    {
        float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
        float N = 1.0f, B = row.move, J = 0.0f, C = 0.0f, ls = 0.0f, E = 0.0f;
        for (int i = 0; i < row.L; ++i) {
            const float* e = emission_row(a.e_odds, row, i);
            ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M,
                                                    row.loop, row.move, fsh, E));
            if (threadIdx.x == 0) {
                fN[i] = N;
                fB[i] = B;
                fJ[i] = J;
                fC[i] = C;
                fE[i] = E;
                flog[i] = ls;
            }
        }
        if (row.L > 0) score = logf(C * row.move + 1e-38f) + ls;
    }
    if (threadIdx.x == 0) score_out[r] = score;

    // pass B: Backward, the posteriors out
    const size_t rows = static_cast<size_t>(a.n_rows) * a.stride;
    float* mocc = post + static_cast<size_t>(r) * a.stride;
    float* pb = mocc + rows;
    float* pe = n_post > 2 ? mocc + 2 * rows : nullptr;
    const ForwardTraj f{fN, fB, fJ, fC, fE, flog};
    Backward<THREADS, CHUNK> bw{tsm, nm, U, bsh};
    bw.init(row.move);
    if (row.L > 0) {
        if (threadIdx.x == 0)
            emit_posterior(f, row.L - 1, row.loop, score, 0.0f, 0.0f, 0.0f, row.move, 0.0f, mocc,
                           pb, pe);
        for (int o = row.L - 2; o >= 0; --o) {
            const float bB =
                bw.step(emission_row(a.e_odds, row, o + 1), row.M, row.loop, row.move);
            if (threadIdx.x == 0)
                emit_posterior(f, o, row.loop, score, bw.bN, bB, bw.bJ, bw.bC, bw.ls, mocc, pb,
                               pe);
        }
    }
    for (int q = 0; q < n_post; ++q) {
        for (int o = row.L + threadIdx.x; o < a.stride; o += THREADS) mocc[q * rows + o] = 0.0f;
    }
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, int n_post, void* score, void* post) {
    const size_t smem =
        sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1 + N_TRAJ * static_cast<size_t>(a.stride));
    cudaError_t err = allow_smem(pair_posterior_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    pair_posterior_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, n_post, static_cast<float*>(score), static_cast<float*>(post));
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r], every profile
// of model length <= width (128, ..., 4096), every sequence of at most
// `stride` residues.  Writes score [n_rows] and post [n_post][n_rows][stride]
// (mocc, pB and, with n_post = 3, pE); returns a CUDA error code.
extern "C" int gecco_pair_posterior(const void* xs, const void* offsets, const void* lens,
                                    const void* loops, const void* moves, const void* seq,
                                    const void* prof, int n_rows, const void* e_odds,
                                    const void* trans, const void* model_len, int P, int Mp,
                                    int width, int stride, int n_post, void* score, void* post,
                                    void* stream) {
    if (n_rows <= 0) return 0;
    if (n_post != 2 && n_post != 3) return static_cast<int>(cudaErrorInvalidValue);
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) launch<T, C>(a, st, n_post, score, post)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
