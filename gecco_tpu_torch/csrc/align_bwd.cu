// Kernel F: alignment Backward, parking the match and insert planes.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_align_bwd.  For each envelope
// row it runs the same Backward recurrence as kernel E (backward_step.cuh;
// the pass is align_pass.cuh's park_backward, shared with kernel K) over
// the row's whole sequence and writes, at every residue o:
//
//   planes[0][row][o][k] = bM_k, planes[1][row][o][k] = bI_k   (bfloat16,
//     rounded to nearest even as astype(bfloat16) does),
//   logs[0][row][o] = ls, logs[1..3][row][o] = log(bX + 1e-38) + ls for
//     X = N, J, C (at o = L-1: -1e30, -1e30, log(move)),
//
// zero from the row's length to the stride.  Kernel G reads them.
//
// Bound on the H100: the per-residue chain of kernel E, plus 4 bytes of
// plane stores per DP cell (coalesced: a thread stores CHUNK neighbouring
// nodes, the block a whole residue row).
//
// Design: kernel E's, without the posterior.  The planes are [rows,
// stride, width] in row order, not the TPU's [cells, Lps, C, Mp] stream.
#include "align_pass.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
align_bwd_kernel(RowArgs a, __nv_bfloat16* __restrict__ planes, float* __restrict__ logs) {
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
    __nv_bfloat16* pM = planes + at * WIDTH;
    __nv_bfloat16* pI = planes + (rows + at) * WIDTH;
    float* blog = logs + at;
    float* bNl = logs + rows + at;
    float* bJl = logs + 2 * rows + at;
    float* bCl = logs + 3 * rows + at;
    park_backward<THREADS, CHUNK>(a, row, tsm, nm, U, sh,
                                  ParkedOut{pM, pI, blog, bNl, bJl, bCl, 0}, 0, row.L - 1);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (size_t idx = static_cast<size_t>(row.L) * WIDTH + threadIdx.x;
         idx < static_cast<size_t>(a.stride) * WIDTH; idx += THREADS) {
        pM[idx] = zero;
        pI[idx] = zero;
    }
    for (int o = row.L + threadIdx.x; o < a.stride; o += THREADS) {
        blog[o] = 0.0f;
        bNl[o] = 0.0f;
        bJl[o] = 0.0f;
        bCl[o] = 0.0f;
    }
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, void* planes, void* logs) {
    const size_t smem = sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(align_bwd_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    align_bwd_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, static_cast<__nv_bfloat16*>(planes), static_cast<float*>(logs));
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_posterior_fwd's.  Writes planes [2][n_rows][stride][width]
// (bfloat16) and logs [4][n_rows][stride]; returns a CUDA error code.
extern "C" int gecco_align_bwd(const void* xs, const void* offsets, const void* lens,
                               const void* loops, const void* moves, const void* seq,
                               const void* prof, int n_rows, const void* e_odds,
                               const void* trans, const void* model_len, int P, int Mp,
                               int width, int stride, void* planes, void* logs, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) launch<T, C>(a, st, planes, logs)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
