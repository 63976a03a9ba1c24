// Kernel K: envelope alignment of listed pairs in one launch — Backward
// planes, posteriors, envelope Forward rescore, optimal-accuracy endpoints
// and null2.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_align (the second stage
// of PairDomains).  For envelope row r (sequence, profile, envelope
// [iv, jv] 1-based inclusive, Forward score `total` of the pair) it runs
// both passes of align_pass.cuh:
//
//   pass 1 (park): the Backward recurrence from the last residue down to
//     iv, parking the bfloat16 match and insert planes and the four log
//     specials of residues iv..jv (kernels.py:2189-2229; the TPU kernel
//     parks all L rows, but its Forward pass reads none outside the
//     envelope, kernels.py:2244-2276);
//   pass 2 (align): the Forward pass from the first residue to jv that
//     folds the parked rows into posteriors, runs the envelope's own
//     Forward and the optimal-accuracy DP with start payloads, and ends
//     with the 21 null2 log-ratios (kernels.py:2231-2404).
//
// Outputs as kernel G's: out[slot] = [envsc, 21 logs], coords[slot] =
// [target from, target to, hmm from, hmm to]; the row's envelope and
// total are read, and its outputs written, at its output slot (out_row:
// its index in the caller's order).
//
// The planes are 2 x 2 bytes x (jv - iv + 1) x width a row: 256 KB at 512
// residues and 128 nodes, more than a block's shared memory, so each row
// parks them in its own slice of a scratch tensor in device memory
// (`planes` [2][n_out][env_stride][plane_width], `logs`
// [4][n_out][env_stride], env_stride the launch's longest envelope) that
// no other warp or block touches; the L2 cache holds a slice between the
// passes.
//
// Bound on the H100: the per-residue dependency chains; ~24 float
// operations per DP cell from iv to the last residue (pass 1) and ~64 from
// the first residue to jv (pass 2).
//
// Design, widths 128 and 256 (kernels F's and G's warp bodies, align_bwd.cu
// and align_fwd.cu): one warp per row, lane l holding nodes [l*C, (l+1)*C)
// in registers, C = ceil(M / 32) for a profile of M nodes.  Blocks take
// runs of rows of ONE profile, one a warp (hmm.kernels.pair_blocks); the
// block stages the profile's 8 transition and 21 emission-odds rows once,
// lane-interleaved, and one warp computes the Backward delete chain's
// basis U into a 30th row; a lane keeps its transitions in registers.
// Pass 1 is warp_park_backward (kernel F's body, parking only iv..jv: each
// lane stores its own C bfloat16 values of a residue row, the logs 32 at a
// time), then a __syncwarp orders the warp's stores before pass 2 reads
// them back with plain (not read-only) loads.  Pass 2 is
// warp_envelope_forward, then warp_align_forward (kernel G's warp body:
// the OA handoff a shuffle, the delete max-scan a shuffle scan, the row
// max a butterfly).  No barrier in either residue loop.  nm, U and the
// Backward chain's slopes are loaded afresh for each row's pass 1, so
// that they hold no registers during pass 2.
//
// Design, widths 512 to 4,096: one block per row, CHUNK nodes a thread at
// kernel G's thread shapes (G's warp form lost there, PERF.md): the
// block-level park_backward (two barriers a residue) and align_forward
// (five inside the envelope); transitions and the node mask staged once
// for both passes; pass 1's delete-chain basis U and pass 2's matocc and
// insocc share one region of shared memory.  Thread t reads back the nodes
// it wrote; the logs are thread 0's, read by all after the barrier between
// the passes.
#include "align_pass.cuh"

using namespace gecco;

namespace {

// rows a block (hmm.stream.ALIGN_FWD_BLOCK_ROWS), one a warp, and the
// blocks an SM the registers must leave room for: kernel G's warp form
// (align_fwd.cu), whose pass 2 holds the most
constexpr int K_WARPS = 4;
template <int C>
constexpr int K_MIN_BLOCKS = C <= 4 ? 3 : 2;
// rows of the staged table: 8 transitions, 21 emission odds (nm is the
// last), U
constexpr int K_SLOTS = N_TRANS + K_ALPHA + 1;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;  // the staged table, K_SLOTS rows of 32 * C nodes
    int first, count, n_out, plane_width, env_stride;
    const int32_t *iv, *jv;
    const float* total;
    __nv_bfloat16* planes;
    float* logs;
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
    const size_t pw = static_cast<size_t>(t.plane_width);
    const size_t plane = static_cast<size_t>(t.n_out) * t.env_stride * pw;  // one plane
    const size_t rows = static_cast<size_t>(t.n_out) * t.env_stride;       // one log row

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int8_t* xs = t.a.xs + t.a.offsets[s];
        const int L = t.a.lens[s];
        const float loop = t.a.loops[s];
        const float move = t.a.moves[s];
        const int slot = t.out_row[row];
        const int iv = t.iv[slot];
        const int jv = t.jv[slot];
        const size_t at = static_cast<size_t>(slot) * t.env_stride;
        __nv_bfloat16* pM = t.planes + at * pw;
        float* blog = t.logs + at;
        const ParkedOut parked{pM, pM + plane, blog, blog + rows, blog + 2 * rows,
                               blog + 3 * rows, iv - 1, pw};
        {
            const LaneRows<C, 2, true> nu(t.smem + (N_TRANS + K_ALPHA - 1) * W + lane);  // nm, U
            const ChainScan right = chain_scan_right<C>(tr);
            warp_park_backward<C>(xs, L, loop, move, esm, tr, nu, right, parked, iv - 1, jv - 1,
                                  4 * C, nullptr);
        }
        __syncwarp();  // pass 1's parked rows before pass 2 reads them
        float* out = t.out + static_cast<size_t>(slot) * 22;
        warp_envelope_forward<C>(xs, iv, jv, esm, tr, chain, out);
        const WarpParked pk{pM, pM + plane, blog, blog + rows, blog + 2 * rows, blog + 3 * rows,
                            pw, iv - 1};
        warp_align_forward<C, false>(xs, L, loop, move, iv, jv, t.total[slot], pk, esm, tr,
                                     chain, g, out, t.coords + static_cast<size_t>(slot) * 4);
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * K_WARPS, K_MIN_BLOCKS<CMAX>)
pair_align_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                  const int32_t* __restrict__ out_row, int n_out, int plane_width,
                  const int32_t* __restrict__ iv, const int32_t* __restrict__ jv,
                  const float* __restrict__ total, int env_stride, __nv_bfloat16* planes,
                  float* logs, float* __restrict__ out, int32_t* __restrict__ coords) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    extern __shared__ float smem[];  // [K_SLOTS][W], lane-interleaved

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    const int W = 32 * c;
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * K_WARPS);
    __syncthreads();
    if (threadIdx.x < 32)
        warp_delete_basis(smem, smem + (N_TRANS + K_ALPHA - 1) * W, smem + (K_SLOTS - 1) * W, c);
    __syncthreads();

    const Rows t{a, out_row, smem, first, count, n_out, plane_width, env_stride, iv, jv, total,
                 planes, logs, out, coords};
    align_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
pair_align_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                       int plane_width, const int32_t* __restrict__ iv_in,
                       const int32_t* __restrict__ jv_in, const float* __restrict__ total_in,
                       int env_stride, __nv_bfloat16* planes, float* logs,
                       float* __restrict__ out, int32_t* __restrict__ coords) {
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

    const int slot = out_row[r];
    const int iv = iv_in[slot];
    const int jv = jv_in[slot];
    const size_t pw = static_cast<size_t>(plane_width);
    const size_t rows = static_cast<size_t>(n_out) * env_stride;
    const size_t at = static_cast<size_t>(slot) * env_stride;
    float* blog = logs + at;
    const ParkedOut parked{planes + at * pw, planes + (rows + at) * pw,
                           blog, blog + rows, blog + 2 * rows, blog + 3 * rows, iv - 1, pw};
    park_backward<THREADS, CHUNK>(a, row, tsm, nm, U, bsh, parked, iv - 1, jv - 1);
    __syncthreads();  // pass 1 is done with U; its parked rows are visible to the block
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) matocc[base + j] = insocc[base + j] = 0.0f;
    __syncthreads();
    align_forward<THREADS, CHUNK>(a, row, slot, tsm, nm, matocc, insocc, fsh, ash, parked, iv,
                                  jv, total_in[slot], out, coords);
}

struct Args {
    const int32_t* out_row;
    int n_out, plane_width;
    const int32_t *iv, *jv;
    const float* total;
    int env_stride;
    __nv_bfloat16* planes;
    float* logs;
    float* out;
    int32_t* coords;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Args& o,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * K_SLOTS * 32 * C;
    cudaError_t err = allow_smem(pair_align_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    pair_align_kernel<C><<<n_blocks, 32 * K_WARPS, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.plane_width, o.iv, o.jv, o.total, o.env_stride,
        o.planes, o.logs, o.out, o.coords);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Args& o, cudaStream_t st) {
    const size_t smem = sizeof(float) * ((N_TRANS + 3) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(pair_align_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    pair_align_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.plane_width, o.iv, o.jv, o.total, o.env_stride, o.planes,
        o.logs, o.out, o.coords);
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r], each at output
// row out_row[r]: its envelope iv/jv (1 <= iv <= jv <= length, jv - iv + 1
// <= env_stride) and Forward score total [n_out] are read, and out
// [n_out][22] (envelope score, 21 null2 log-ratios) and coords [n_out][4]
// written, there; planes [2][n_out][env_stride][plane_width] (bfloat16,
// plane_width >= width, a multiple of 128) and logs [4][n_out][env_stride]
// are scratch.  Widths 128 and 256 take every row of one width class, cut
// by `blocks` [n_blocks][2] int32 (first row, row count) into runs of one
// profile (hmm.kernels.pair_blocks); widths 512 to 4,096 ignore it and
// take one block a row.  Returns a CUDA error code.
extern "C" int gecco_pair_align(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, const void* seq,
                                const void* prof, int n_rows, const void* e_odds,
                                const void* trans, const void* model_len, int P, int Mp,
                                int width, int stride, const void* blocks, int n_blocks,
                                const void* out_row, int n_out, int plane_width, const void* iv,
                                const void* jv, const void* total, int env_stride, void* planes,
                                void* logs, void* out, void* coords, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Args o{static_cast<const int32_t*>(out_row), n_out, plane_width,
                 static_cast<const int32_t*>(iv), static_cast<const int32_t*>(jv),
                 static_cast<const float*>(total), env_stride,
                 static_cast<__nv_bfloat16*>(planes), static_cast<float*>(logs),
                 static_cast<float*>(out), static_cast<int32_t*>(coords)};
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
