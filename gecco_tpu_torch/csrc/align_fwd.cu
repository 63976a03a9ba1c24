// Kernel G: alignment Forward — posteriors, envelope Forward rescore,
// optimal-accuracy endpoints and null2 of each envelope row.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_align_fwd.  For envelope row r
// (sequence, profile, envelope [iv, jv] 1-based inclusive, Forward score
// `total` of the pair) it runs align_pass.cuh's align_forward (shared with
// kernel K) over kernel F's parked planes and logs: the full-sequence
// Forward with the posteriors, the envelope's own Forward, the
// optimal-accuracy DP with start payloads, and the 21 null2 log-ratios.
// Outputs: out[r] = [envsc, 21 logs], coords[r] = [target from, target to,
// hmm from, hmm to].
//
// Bound on the H100: the per-residue chain, five barriers a residue inside
// the envelope (two per Forward, one for the delete max-scan and the row
// max), two outside it; ~17 state values a node.  At 4,096 nodes the
// registers (12 values a node in registers, matocc and insocc in shared
// memory) exceed what 512 threads can hold, and the compiler spills.
//
// Design: one block per envelope row, CHUNK nodes a thread; transitions,
// the node mask, matocc and insocc in shared memory; see align_pass.cuh.
#include "align_pass.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
align_fwd_kernel(RowArgs a, const __nv_bfloat16* __restrict__ planes,
                 const float* __restrict__ logs, const int32_t* __restrict__ iv_in,
                 const int32_t* __restrict__ jv_in, const float* __restrict__ total_in,
                 float* __restrict__ out, int32_t* __restrict__ coords) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float smem[];  // trans [8][W], nm [W], matocc [W], insocc [W]
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ AlignScratch<THREADS> ash;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* matocc = nm + WIDTH;
    float* insocc = matocc + WIDTH;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    const int base = threadIdx.x * CHUNK;
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) matocc[base + j] = insocc[base + j] = 0.0f;
    __syncthreads();

    const size_t rows = static_cast<size_t>(a.n_rows) * a.stride;
    const size_t at = static_cast<size_t>(r) * a.stride;
    const float* blog = logs + at;
    const ParkedIn parked{planes + at * WIDTH, planes + (rows + at) * WIDTH,
                          blog, blog + rows, blog + 2 * rows, blog + 3 * rows, 0};
    align_forward<THREADS, CHUNK>(a, row, r, tsm, nm, matocc, insocc, fsh, ash, parked, iv_in[r],
                                  jv_in[r], total_in[r], out, coords);
}

template <int THREADS, int CHUNK>
cudaError_t launch(const RowArgs& a, cudaStream_t st, const void* planes, const void* logs,
                   const void* iv, const void* jv, const void* total, void* out, void* coords) {
    const size_t smem = sizeof(float) * (N_TRANS + 3) * THREADS * CHUNK;
    cudaError_t err = allow_smem(align_fwd_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    align_fwd_kernel<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, static_cast<const __nv_bfloat16*>(planes), static_cast<const float*>(logs),
        static_cast<const int32_t*>(iv), static_cast<const int32_t*>(jv),
        static_cast<const float*>(total), static_cast<float*>(out),
        static_cast<int32_t*>(coords));
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_align_bwd's, with its planes and logs, envelopes iv/jv
// (1 <= iv <= jv <= length) and Forward scores total [n_rows].  Writes
// out [n_rows][22] (envelope score, 21 null2 log-ratios) and coords
// [n_rows][4]; returns a CUDA error code.
extern "C" int gecco_align_fwd(const void* xs, const void* offsets, const void* lens,
                               const void* loops, const void* moves, const void* seq,
                               const void* prof, int n_rows, const void* e_odds,
                               const void* trans, const void* model_len, int P, int Mp,
                               int width, int stride, const void* planes, const void* logs,
                               const void* iv, const void* jv, const void* total, void* out,
                               void* coords, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C) launch<T, C>(a, st, planes, logs, iv, jv, total, out, coords)
    cudaError_t err;
    GECCO_DISPATCH_ALIGN(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
