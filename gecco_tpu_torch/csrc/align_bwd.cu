// Kernel F: alignment Backward, parking the match and insert planes.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_align_bwd.  For each envelope
// row it runs the same Backward recurrence as kernel E (backward_step.cuh)
// over the row's whole sequence and writes, at every residue o of output
// row `slot` (out_row: the row's index in the caller's order):
//
//   planes[0][slot][o][k] = bM_k, planes[1][slot][o][k] = bI_k   (bfloat16,
//     rounded to nearest even as astype(bfloat16) does; zero past the
//     nodes the row computes, to the planes' width),
//   logs[0][slot][o] = ls, logs[1..3][slot][o] = log(bX + 1e-38) + ls for
//     X = N, J, C (at o = L-1: -1e30, -1e30, log(move)),
//
// zero from the row's length to the stride.  Kernel G reads them.
//
// Bound on the H100: the bytes of the planes (4 bytes a DP cell, the
// planes' full width a residue) where rows are many; the per-residue chain
// of kernel E (~24 float operations a cell) where they are few.
//
// Design, widths 128 to 1,024 (kernel D's, stream_fwd.cu): one warp per
// row, lane l holding nodes [l*C, (l+1)*C) of bM and bI in registers, C =
// ceil(M / 32) for a profile of M nodes.  Blocks take runs of rows of ONE
// profile, one a warp (hmm.kernels.pair_blocks); the block stages the
// profile's 8 transition and 21 emission-odds rows once, lane-interleaved,
// and one warp computes the delete chain's basis U (the chain of nm alone)
// into a 30th row; at C <= 8 a lane keeps its transitions, nm and U in
// registers.  A row is warp_park_backward (align_pass.cuh, shared with
// kernel K).  Per residue: the residue from ResidueStreamRev (read from
// the last one down), the next step's emissions read one step ahead,
// warp_backward_step (one shuffle, a five-step shuffle scan from the right
// for the delete chain, bB one warp sum), no barrier; then the warp writes
// each plane's residue row as contiguous bytes, the nodes from 32 * C to
// the planes' width as zeros in 16-byte stores.  At C <= 8 each lane stores
// its C values as bfloat16 vectors (16 bytes at C = 8, 8 at C = 4, the
// lanes side by side); above, the lanes put their values in a row of
// shared memory of the warp's own and the warp stores that row 16 bytes
// a lane (__syncwarp, no barrier): with each lane's own 16-byte stores,
// 2 * C bytes apart, the kernel took 3x as long at C = 32 on an H100
// (tools/torch_domain_kernels.py).
// Lane o mod 32 keeps residue o's bN, bJ, bC and log scale; every 32
// residues the warp takes their logs and stores 32 consecutive floats of
// each of the four log rows.  The zero fill from L to the stride is 16-byte
// stores.  Each row is written in place at its output slot.
//
// Design, widths 2,048 and 4,096: kernel E's, a block per row, without the
// posterior (align_pass.cuh's park_backward, shared with kernel K).  The
// planes are [rows, stride, width] in row order, not the TPU's [cells,
// Lps, C, Mp] stream.
#include <type_traits>

#include "align_pass.cuh"

using namespace gecco;

namespace {

// warps a block and the blocks an SM the registers must leave room for:
// kernel D's (stream_fwd.cu) above 8 nodes a lane; at 8 and fewer, fewer
// blocks than D's, whose caps (6 and 4) spilled 144 and 204 bytes here
template <int C>
constexpr int F_WARPS = C <= 8 ? 4 : 8;
template <int C>
constexpr int F_MIN_BLOCKS = C <= 4 ? 4 : C <= 8 ? 3 : C <= 16 ? 2 : 1;
// rows of the staged table: 8 transitions, 21 emission odds (nm is the
// last), U
constexpr int F_SLOTS = N_TRANS + K_ALPHA + 1;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;     // the staged table, F_SLOTS rows of 32 * C nodes
    __nv_bfloat16* bufs;   // each warp's two bfloat16 rows of 32 * C nodes (C > 8)
    int first, count, n_out, plane_width;
    __nv_bfloat16* planes;
    float* logs;
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
    constexpr bool REG = C <= 8;
    using Trans = std::conditional_t<REG, RegTrans<C>, SmemTrans<C>>;
    const Trans tr(t.smem + lane);
    const LaneRows<C, 2, REG> nu(t.smem + (N_TRANS + K_ALPHA - 1) * W + lane);  // nm, U
    const ChainScan right = chain_scan_right<C>(tr);
    const int stride = t.a.stride;
    const int chunks = t.plane_width / 8;  // 16-byte chunks of a plane's residue row
    const size_t rows = static_cast<size_t>(t.n_out) * stride;  // one log row
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    __nv_bfloat16* buf = t.bufs + (threadIdx.x >> 5) * 2 * W;

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int L = t.a.lens[s];
        const size_t at = static_cast<size_t>(t.out_row[row]) * stride;
        __nv_bfloat16* pM = t.planes + at * t.plane_width;
        __nv_bfloat16* pI = t.planes + (rows + at) * t.plane_width;
        float* lg = t.logs + at;  // log row q at lg + q * rows
        const ParkedOut pk{pM, pI, lg, lg + rows, lg + 2 * rows, lg + 3 * rows, 0,
                           static_cast<size_t>(t.plane_width)};
        warp_park_backward<C>(t.a.xs + t.a.offsets[s], L, t.a.loops[s], t.a.moves[s], esm, tr, nu,
                              right, pk, 0, L - 1, chunks, buf);
        const size_t tail = static_cast<size_t>(stride - L) * chunks;
        uint4* zM = reinterpret_cast<uint4*>(pM + static_cast<size_t>(L) * t.plane_width);
        uint4* zI = reinterpret_cast<uint4*>(pI + static_cast<size_t>(L) * t.plane_width);
        for (size_t q = lane; q < tail; q += 32) {
            zM[q] = zero;
            zI[q] = zero;
        }
        for (int o = L + lane; o < stride; o += 32) {
#pragma unroll
            for (int q = 0; q < 4; ++q) lg[q * rows + o] = 0.0f;
        }
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * F_WARPS<CMAX>, F_MIN_BLOCKS<CMAX>)
align_bwd_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                 const int32_t* __restrict__ out_row, int n_out, int plane_width,
                 __nv_bfloat16* __restrict__ planes, float* __restrict__ logs) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = F_WARPS<CMAX>;
    // [F_SLOTS][W], lane-interleaved; at CMAX > 8 each warp's two rows of
    // bfloat16 planes after the table's largest size
    extern __shared__ float smem[];

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    const int W = 32 * c;
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * WARPS);
    __syncthreads();
    if (threadIdx.x < 32)
        warp_delete_basis(smem, smem + (N_TRANS + K_ALPHA - 1) * W, smem + (F_SLOTS - 1) * W, c);
    __syncthreads();

    const Rows t{a, out_row, smem,
                 reinterpret_cast<__nv_bfloat16*>(smem + F_SLOTS * 32 * CMAX),
                 first, count, n_out, plane_width, planes, logs};
    align_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
align_bwd_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                      __nv_bfloat16* __restrict__ planes, float* __restrict__ logs) {
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

    const size_t rows = static_cast<size_t>(n_out) * a.stride;
    const size_t at = static_cast<size_t>(out_row[r]) * a.stride;
    __nv_bfloat16* pM = planes + at * WIDTH;
    __nv_bfloat16* pI = planes + (rows + at) * WIDTH;
    float* blog = logs + at;
    float* bNl = logs + rows + at;
    float* bJl = logs + 2 * rows + at;
    float* bCl = logs + 3 * rows + at;
    park_backward<THREADS, CHUNK>(a, row, tsm, nm, U, sh,
                                  ParkedOut{pM, pI, blog, bNl, bJl, bCl, 0, WIDTH}, 0, row.L - 1);
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

struct Out {
    const int32_t* out_row;
    int n_out, plane_width;
    __nv_bfloat16* planes;
    float* logs;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Out& o,
                         cudaStream_t st) {
    // the table, then (C > 8) two bfloat16 rows a warp: one float row a warp
    const size_t smem = sizeof(float) * (F_SLOTS + (C > 8 ? F_WARPS<C> : 0)) * 32 * C;
    cudaError_t err = allow_smem(align_bwd_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    align_bwd_kernel<C><<<n_blocks, 32 * F_WARPS<C>, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.plane_width, o.planes, o.logs);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Out& o, cudaStream_t st) {
    if (o.plane_width != THREADS * CHUNK) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(align_bwd_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    align_bwd_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.planes, o.logs);
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_posterior_fwd's, written at output row out_row[r] of
// planes [2][n_out][stride][plane_width] (bfloat16) and logs
// [4][n_out][stride].  Widths 128 to 1,024 take plane_width >= width (a
// multiple of 128); widths 2,048 and 4,096 take plane_width == width.
// Returns a CUDA error code.
extern "C" int gecco_align_bwd(const void* xs, const void* offsets, const void* lens,
                               const void* loops, const void* moves, const void* seq,
                               const void* prof, int n_rows, const void* e_odds,
                               const void* trans, const void* model_len, int P, int Mp,
                               int width, int stride, const void* blocks, int n_blocks,
                               const void* out_row, int n_out, int plane_width, void* planes,
                               void* logs, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Out o{static_cast<const int32_t*>(out_row), n_out, plane_width,
                static_cast<__nv_bfloat16*>(planes), static_cast<float*>(logs)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 1024 && (runs == nullptr || n_blocks <= 0)) return cudaErrorInvalidValue;
    if (plane_width < width || plane_width % 128 != 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (width) {
        case 128: err = launch_warps<4>(a, runs, n_blocks, o, st); break;
        case 256: err = launch_warps<8>(a, runs, n_blocks, o, st); break;
        case 512: err = launch_warps<16>(a, runs, n_blocks, o, st); break;
        case 1024: err = launch_warps<32>(a, runs, n_blocks, o, st); break;
        case 2048: err = launch_wide<256, 8>(a, o, st); break;
        case 4096: err = launch_wide<256, 16>(a, o, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
