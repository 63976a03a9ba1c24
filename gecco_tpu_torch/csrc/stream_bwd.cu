// Kernel E: posterior Backward -> match occupancy and begin posterior.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_bwd.  For each row it runs
// the Backward recurrence of backward_step.cuh from the initial row at
// o = L-1 down to o = 0 and, at every residue, combines the Backward
// specials of o with kernel D's Forward trajectories of o and o-1
// (traj [5][rows][stride]: N, B, J, C, log scale; N=1, J=C=0 and log
// scale 0 before the first residue) and the Forward score `total`:
//
//   ppX = fX(o-1) * loop * bX(o) * exp(fls(o-1) + bls(o) - total), X = N, J, C,
//   mocc(o) = clip(1 - ppN - ppJ - ppC, 0, 1),
//   pB(o) = fB(o) * bB(o) * exp(fls(o) + bls(o) - total),
//
// written to post[0][row][o] and post[1][row][o], zero from L to stride.
// The JAX kernel reads o-1 from shifted copies of the trajectories; here
// the thread that writes reads it directly.
//
// Bound on the H100: the per-residue dependency chain (two barriers, a
// block sum and a scan across nodes per residue); ~14 float operations
// and one emission read per DP cell.
//
// Design: one block per row, CHUNK nodes a thread; transitions, the node
// mask and the delete-chain basis U in shared memory; see
// backward_step.cuh.  The TPU kernel's reversed block maps, its `binit`
// and `ekeep` scratch carries have no counterpart: the block walks its
// own row from the end.
#include "backward_step.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
posterior_bwd_kernel(RowArgs a, const float* __restrict__ traj,
                     const float* __restrict__ score, float* __restrict__ post) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float smem[];  // trans [8][W], nm [W], U [W + 1]
    __shared__ BackwardScratch<THREADS> sh;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* U = nm + WIDTH;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
    __syncthreads();

    const size_t rows = static_cast<size_t>(a.n_rows) * a.stride;
    const size_t at = static_cast<size_t>(r) * a.stride;
    const float* fN = traj + at;
    const ForwardTraj f{fN, fN + rows, fN + 2 * rows, fN + 3 * rows, nullptr, fN + 4 * rows};
    float* mocc = post + at;
    float* pb = post + rows + at;
    const float total = score[r];
    const float loop = row.loop;

    // the posteriors of residue o from the Backward specials of o
    auto emit = [&](int o, float bN, float bB, float bJ, float bC, float ls) {
        emit_posterior(f, o, loop, total, bN, bB, bJ, bC, ls, mocc, pb, nullptr);
    };

    Backward<THREADS, CHUNK> bw{tsm, nm, U, sh};
    bw.init(row.move);
    if (row.L > 0) {
        if (threadIdx.x == 0) emit(row.L - 1, 0.0f, 0.0f, 0.0f, row.move, 0.0f);
        for (int o = row.L - 2; o >= 0; --o) {
            const float bB = bw.step(emission_row(a.e_odds, row, o + 1), row.M, loop, row.move);
            if (threadIdx.x == 0) emit(o, bw.bN, bB, bw.bJ, bw.bC, bw.ls);
        }
    }
    for (int o = row.L + threadIdx.x; o < a.stride; o += THREADS) {
        mocc[o] = 0.0f;
        pb[o] = 0.0f;
    }
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, const void* traj, const void* score,
                   void* post) {
    const size_t smem = sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(posterior_bwd_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    posterior_bwd_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, static_cast<const float*>(traj), static_cast<const float*>(score),
        static_cast<float*>(post));
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_posterior_fwd's, with its traj [5][n_rows][stride] and
// score [n_rows].  Writes post [2][n_rows][stride] (mocc, pB); returns a
// CUDA error code.
extern "C" int gecco_posterior_bwd(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* seq,
                                   const void* prof, int n_rows, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, int stride, const void* traj, const void* score,
                                   void* post, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) launch<T, C>(a, st, traj, score, post)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
