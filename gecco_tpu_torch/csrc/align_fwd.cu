// Kernel G: alignment Forward — posteriors, envelope Forward rescore,
// optimal-accuracy endpoints and null2 of each envelope row.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_align_fwd.  For envelope row r
// (sequence, profile, envelope [iv, jv] 1-based inclusive, Forward score
// `total` of the pair) it runs align_pass.cuh's alignment Forward pass over
// kernel F's parked planes and logs: the full-sequence Forward with the
// posteriors, the envelope's own Forward, the optimal-accuracy DP with
// start payloads, and the 21 null2 log-ratios.  Outputs: out[slot] =
// [envsc, 21 logs], coords[slot] = [target from, target to, hmm from, hmm
// to]; the row's inputs (planes, logs, iv, jv, total) are read, and its
// outputs written, at its output slot (out_row: its index in the
// caller's order).
//
// Bound on the H100: the latency of the per-residue chain inside the
// envelope (two Forward steps, the OA cells, a max-plus scan and a row
// max across the nodes; ~64 float operations a DP cell); ~14 state values
// a node, so registers limit how many rows an SM holds.
//
// Design, widths 128 and 256 (kernels D and F's, stream_fwd.cu and
// align_bwd.cu): one warp per row, lane l holding nodes [l*C, (l+1)*C) in
// registers, C = ceil(M / 32) for a profile of M nodes.  Blocks take runs
// of rows of ONE profile (hmm.kernels.pair_blocks), one a warp; the block
// stages the profile's 8 transition and 21 emission-odds rows once,
// lane-interleaved (the emission rows serve the Forward steps, the node
// mask and null2), and a lane keeps its transitions in registers.  The
// warp first runs the envelope's own Forward over [iv, jv]
// (warp_envelope_forward: it needs only the residues), then the full
// Forward, the posteriors from F's parked bfloat16 rows (a lane's own 2C
// bytes, read before the step that needs them) and the OA DP
// (warp_align_forward), so that neither pass carries the other's state.
// No barrier in the residue loop: the OA handoff is a shuffle, the delete
// max-scan a shuffle scan, the row max a butterfly; the special-state
// posteriors are kept a residue a lane and summed 32 at a time.  (The
// envelope Forward on a second warp of the row ran short launches of 256
// nodes faster, but held each row's registers twice and lost on long
// ones; at 16 and 32 nodes a lane the warp form lost to the block form
// even with matocc, insocc and the OA insert and delete cells in the
// warp's own slice of shared memory: tools/torch_domain_kernels.py on an
// H100, PERF.md.)
//
// Design, widths 512 to 4,096: one block per row, CHUNK nodes a thread
// (align_forward, shared with kernel K); transitions, the node mask,
// matocc and insocc in shared memory; five barriers a residue inside the
// envelope.  At 4,096 nodes the registers (12 values a node, matocc and
// insocc in shared memory) exceed what 512 threads can hold, and the
// compiler spills.
#include "align_pass.cuh"

using namespace gecco;

namespace {

// rows a block (hmm.stream.ALIGN_FWD_BLOCK_ROWS), one a warp, and the
// blocks an SM the registers must leave room for (caps of 168 and 255
// registers: a cap of 128 at 128 nodes spilled 472 bytes, and of 168 at
// 256 nodes 1,952)
constexpr int G_WARPS = 4;
template <int C>
constexpr int G_MIN_BLOCKS = C <= 4 ? 3 : 2;
// rows of the staged table: 8 transitions, 21 emission odds (nm is the last)
constexpr int G_SLOTS = N_TRANS + K_ALPHA;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;  // the staged table, G_SLOTS rows of 32 * C nodes
    int first, count, n_out, plane_width;
    const __nv_bfloat16* planes;
    const float* logs;
    const int32_t *iv, *jv;
    const float* total;
    float* out;
    int32_t* coords;
};

// The block's rows, C nodes a lane, warp w taking rows w, w + warps, ...
// The block runs the body of C = ceil(M / 32) (C0 up to CMAX).
template <int C0, int CMAX>
__device__ __forceinline__ void align_rows(int c, const Rows& t) {
    if constexpr (C0 < CMAX) {
        if (c > C0) {
            align_rows<C0 + 1, CMAX>(c, t);
            return;
        }
    }
    constexpr int C = C0;
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    const float* esm = t.smem + N_TRANS * W + lane;
    const RegTrans<C> tr(t.smem + lane);
    const ChainScan chain = chain_scan<C>(tr);
    const GateBits g = gate_bits<C>(tr, esm + 20 * W);
    const int stride = t.a.stride;
    const size_t rows = static_cast<size_t>(t.n_out) * stride;  // one log row
    const size_t pw = static_cast<size_t>(t.plane_width);

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int slot = t.out_row[row];
        const int8_t* xs = t.a.xs + t.a.offsets[s];
        const int iv = t.iv[slot];
        const int jv = t.jv[slot];
        float* out = t.out + static_cast<size_t>(slot) * 22;
        warp_envelope_forward<C>(xs, iv, jv, esm, tr, chain, out);
        const size_t at = static_cast<size_t>(slot) * stride;
        const float* blog = t.logs + at;
        const WarpParked pk{t.planes + at * pw, t.planes + (rows + at) * pw, blog,
                            blog + rows, blog + 2 * rows, blog + 3 * rows, pw, 0};
        warp_align_forward<C>(xs, t.a.lens[s], t.a.loops[s], t.a.moves[s], iv, jv,
                              t.total[slot], pk, esm, tr, chain, g, out,
                              t.coords + static_cast<size_t>(slot) * 4);
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * G_WARPS, G_MIN_BLOCKS<CMAX>)
align_fwd_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                 const int32_t* __restrict__ out_row, int n_out, int plane_width,
                 const __nv_bfloat16* __restrict__ planes, const float* __restrict__ logs,
                 const int32_t* __restrict__ iv, const int32_t* __restrict__ jv,
                 const float* __restrict__ total, float* __restrict__ out,
                 int32_t* __restrict__ coords) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    extern __shared__ float smem[];  // [G_SLOTS][W], lane-interleaved

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * G_WARPS);
    __syncthreads();

    const Rows t{a, out_row, smem, first, count, n_out, plane_width, planes, logs, iv, jv,
                 total, out, coords};
    align_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
align_fwd_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                      int plane_width, const __nv_bfloat16* __restrict__ planes,
                      const float* __restrict__ logs,
                      const int32_t* __restrict__ iv, const int32_t* __restrict__ jv,
                      const float* __restrict__ total, float* __restrict__ out,
                      int32_t* __restrict__ coords) {
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

    const int slot = out_row[r];
    const size_t rows = static_cast<size_t>(n_out) * a.stride;
    const size_t at = static_cast<size_t>(slot) * a.stride;
    const size_t pw = static_cast<size_t>(plane_width);
    const float* blog = logs + at;
    const ParkedIn parked{planes + at * pw, planes + (rows + at) * pw,
                          blog, blog + rows, blog + 2 * rows, blog + 3 * rows, 0, pw};
    align_forward<THREADS, CHUNK>(a, row, slot, tsm, nm, matocc, insocc, fsh, ash, parked,
                                  iv[slot], jv[slot], total[slot], out, coords);
}

struct Args {
    const int32_t* out_row;
    int n_out, plane_width;
    const __nv_bfloat16* planes;
    const float* logs;
    const int32_t *iv, *jv;
    const float* total;
    float* out;
    int32_t* coords;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Args& o,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * G_SLOTS * 32 * C;
    cudaError_t err = allow_smem(align_fwd_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    align_fwd_kernel<C><<<n_blocks, 32 * G_WARPS, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.plane_width, o.planes, o.logs, o.iv, o.jv, o.total,
        o.out, o.coords);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Args& o, cudaStream_t st) {
    const size_t smem = sizeof(float) * (N_TRANS + 3) * THREADS * CHUNK;
    cudaError_t err = allow_smem(align_fwd_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    align_fwd_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.plane_width, o.planes, o.logs, o.iv, o.jv, o.total, o.out,
        o.coords);
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_align_bwd's, cut into blocks as its are, each at output
// row out_row[r]: its planes [2][n_out][stride][plane_width] and logs
// [4][n_out][stride], envelope iv/jv (1 <= iv <= jv <= length) and Forward
// score total [n_out] are read, and out [n_out][22] (envelope score, 21
// null2 log-ratios) and coords [n_out][4] written, there; plane_width >=
// width, a multiple of 128.  Widths 128 and 256 take every row of one
// width class, cut by `blocks` into runs of one profile; widths 512 to
// 4,096 ignore it and take one block a row.  Returns a CUDA error code.
extern "C" int gecco_align_fwd(const void* xs, const void* offsets, const void* lens,
                               const void* loops, const void* moves, const void* seq,
                               const void* prof, int n_rows, const void* e_odds,
                               const void* trans, const void* model_len, int P, int Mp,
                               int width, int stride, const void* blocks, int n_blocks,
                               const void* out_row, int n_out, int plane_width,
                               const void* planes, const void* logs, const void* iv,
                               const void* jv, const void* total, void* out, void* coords,
                               void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Args o{static_cast<const int32_t*>(out_row), n_out, plane_width,
                 static_cast<const __nv_bfloat16*>(planes), static_cast<const float*>(logs),
                 static_cast<const int32_t*>(iv), static_cast<const int32_t*>(jv),
                 static_cast<const float*>(total), static_cast<float*>(out),
                 static_cast<int32_t*>(coords)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 256 && (runs == nullptr || n_blocks <= 0)) return cudaErrorInvalidValue;
    if (plane_width < width || plane_width % 128 != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (width) {
        case 128: err = launch_warps<4>(a, runs, n_blocks, o, st); break;
        case 256: err = launch_warps<8>(a, runs, n_blocks, o, st); break;
        case 512: err = launch_wide<128, 4>(a, o, st); break;
        case 1024: err = launch_wide<256, 4>(a, o, st); break;
        case 2048: err = launch_wide<512, 4>(a, o, st); break;
        case 4096: err = launch_wide<512, 8>(a, o, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
