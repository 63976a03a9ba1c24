// Kernel D: posterior Forward with the special-state trajectories.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_fwd (the first pass of
// StreamDomains' posterior decoding).  It is kernel C's Forward
// (forward_step.cuh, rescaled every residue, the block-level step) plus, after each residue i,
// the rescaled N, B, J, C and the running log scale written to
// traj[0..4][row][i], and the final score log(C * move + 1e-38) + ls.
// Trajectories are zero from the row's length to the launch's stride; an
// empty sequence scores -1e30.
//
// Bound on the H100: the latency of the per-residue chain; the
// trajectory writes are 20 bytes a residue, one thread's stores.
//
// Design: one block per row, CHUNK nodes a thread, transitions in shared
// memory, emission rows read by residue index (kernel C's design at 2,048
// and 4,096 nodes).  The TPU
// kernel's L-chunk grid and its VMEM carries have no counterpart: the
// residue loop runs inside the block.
#include "forward_step.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
posterior_fwd_kernel(RowArgs a, float* __restrict__ traj, float* __restrict__ score_out) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ ForwardScratch<THREADS> sh;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    __syncthreads();

    const size_t rows = static_cast<size_t>(a.n_rows) * a.stride;
    float* out = traj + static_cast<size_t>(r) * a.stride;  // slot q at out + q * rows
    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = row.move, J = 0.0f, C = 0.0f, ls = 0.0f;
    float score = NEG;

    for (int i = 0; i < row.L; ++i) {
        const float* e = emission_row(a.e_odds, row, i);
        ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M,
                                                row.loop, row.move, sh));
        if (threadIdx.x == 0) {
            out[i] = N;
            out[rows + i] = B;
            out[2 * rows + i] = J;
            out[3 * rows + i] = C;
            out[4 * rows + i] = ls;
        }
        if (i == row.L - 1) score = logf(C * row.move + 1e-38f) + ls;
    }
    for (int i = row.L + threadIdx.x; i < a.stride; i += THREADS) {
#pragma unroll
        for (int q = 0; q < 5; ++q) out[q * rows + i] = 0.0f;
    }
    if (threadIdx.x == 0) score_out[r] = score;
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, void* traj, void* score) {
    const size_t smem = sizeof(float) * N_TRANS * THREADS * CHUNK;
    cudaError_t err = allow_smem(posterior_fwd_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    posterior_fwd_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, static_cast<float*>(traj), static_cast<float*>(score));
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r], every profile
// of model length <= width (128, ..., 4096).  Writes traj [5][n_rows][stride]
// and score [n_rows]; returns a CUDA error code.
extern "C" int gecco_posterior_fwd(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* seq,
                                   const void* prof, int n_rows, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, int stride, void* traj, void* score,
                                   void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) launch<T, C>(a, st, traj, score)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
