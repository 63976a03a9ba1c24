// Kernel K: envelope alignment of listed pairs in one launch — Backward
// planes, posteriors, envelope Forward rescore, optimal-accuracy endpoints
// and null2.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_align (the second stage
// of PairDomains).  For envelope row r (sequence, profile, envelope
// [iv, jv] 1-based inclusive, Forward score `total` of the pair) the block
// runs both passes of align_pass.cuh:
//
//   pass 1 (park_backward): the Backward recurrence from the last residue
//     down to iv, parking the bfloat16 match and insert planes and the four
//     log specials of residues iv..jv (kernels.py:2189-2229; the TPU kernel
//     parks all L rows, but its Forward pass reads none outside the
//     envelope, kernels.py:2244-2276);
//   pass 2 (align_forward): the Forward pass from the first residue to jv
//     that folds the parked rows into posteriors, runs the envelope's own
//     Forward and the optimal-accuracy DP with start payloads, and ends
//     with the 21 null2 log-ratios (kernels.py:2231-2404).
//
// Outputs as kernel G's: out[r] = [envsc, 21 logs], coords[r] = [target
// from, target to, hmm from, hmm to].
//
// The planes are 2 x 2 bytes x (jv - iv + 1) x width a row: 256 KB at 512
// residues and 128 nodes, more than a block's shared memory, so each block
// parks them in its own slice of a scratch tensor in device memory
// (`planes` [2][rows][env_stride][width], `logs` [4][rows][env_stride],
// env_stride the launch's longest envelope) that no other block touches;
// the L2 cache holds a slice between the passes.  Thread t reads back the
// nodes it wrote; the logs are thread 0's, read by all after the barrier
// between the passes.
//
// Bound on the H100: the per-residue dependency chains, two barriers a
// residue in pass 1, five in pass 2 inside the envelope; ~24 + 64 float
// operations per DP cell of the envelope.  Registers are pass 2's (kernel
// G's: 12 values a node).
//
// Design: one block per envelope row, CHUNK nodes a thread at kernel G's
// thread shapes; transitions and the node mask staged once for both
// passes; pass 1's delete-chain basis U and pass 2's matocc and insocc
// share one region of shared memory.
#include "align_pass.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
pair_align_kernel(RowArgs a, const int32_t* __restrict__ iv_in,
                  const int32_t* __restrict__ jv_in, const float* __restrict__ total_in,
                  int env_stride, __nv_bfloat16* planes, float* logs, float* __restrict__ out,
                  int32_t* __restrict__ coords) {
    constexpr int WIDTH = THREADS * CHUNK;
    // trans [8][W], nm [W], then U [W + 1] (pass 1) or matocc [W], insocc [W] (pass 2)
    extern __shared__ float smem[];
    __shared__ BackwardScratch<THREADS> bsh;
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ AlignScratch<THREADS> ash;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* U = nm + WIDTH;
    float* matocc = nm + WIDTH;
    float* insocc = matocc + WIDTH;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    const int base = threadIdx.x * CHUNK;
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
    __syncthreads();

    const int iv = iv_in[r];
    const int jv = jv_in[r];
    const size_t rows = static_cast<size_t>(a.n_rows) * env_stride;
    const size_t at = static_cast<size_t>(r) * env_stride;
    float* blog = logs + at;
    const ParkedOut parked{planes + at * WIDTH, planes + (rows + at) * WIDTH,
                           blog, blog + rows, blog + 2 * rows, blog + 3 * rows, iv - 1, WIDTH};
    park_backward<THREADS, CHUNK>(a, row, tsm, nm, U, bsh, parked, iv - 1, jv - 1);
    __syncthreads();  // pass 1 is done with U; its parked rows are visible to the block
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) matocc[base + j] = insocc[base + j] = 0.0f;
    __syncthreads();
    align_forward<THREADS, CHUNK>(a, row, r, tsm, nm, matocc, insocc, fsh, ash, parked, iv, jv,
                                  total_in[r], out, coords);
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, const void* iv, const void* jv,
                   const void* total, int env_stride, void* planes, void* logs, void* out,
                   void* coords) {
    const size_t smem = sizeof(float) * ((N_TRANS + 3) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(pair_align_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    pair_align_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, static_cast<const int32_t*>(iv), static_cast<const int32_t*>(jv),
        static_cast<const float*>(total), env_stride, static_cast<__nv_bfloat16*>(planes),
        static_cast<float*>(logs), static_cast<float*>(out), static_cast<int32_t*>(coords));
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r] (model length <=
// width: 128, ..., 4096), envelope iv[r]..jv[r] (1 <= iv <= jv <= length,
// jv - iv + 1 <= env_stride) and Forward score total[r].  planes
// [2][n_rows][env_stride][width] (bfloat16) and logs [4][n_rows][env_stride]
// are scratch.  Writes out [n_rows][22] (envelope score, 21 null2
// log-ratios) and coords [n_rows][4]; returns a CUDA error code.
extern "C" int gecco_pair_align(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, const void* seq,
                                const void* prof, int n_rows, const void* e_odds,
                                const void* trans, const void* model_len, int P, int Mp,
                                int width, int stride, const void* iv, const void* jv,
                                const void* total, int env_stride, void* planes, void* logs,
                                void* out, void* coords, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) \
    launch<T, C>(a, st, iv, jv, total, env_stride, planes, logs, out, coords)
    cudaError_t err;
    GECCO_DISPATCH_ALIGN(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
