// Kernel A: SSV filter scores of every (sequence, profile) pair.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_ssv_quad (the F1 filter of
// SearchPipeline.search, four residues a lane roll) and computes the same
// function as the TPU's other two SSV variants, _pallas_ssv (one residue a
// roll) and _pallas_ssv_pair (two).  For each pair it returns, in nats,
//
//   max_{i,k} A_k(i) + L*loop + log(1/2) + move,
//   A_k(i) = (e_k(x_i) - loop) + max(A_{k-1}(i-1), tbm + move),
//
// the host oracle gecco_tpu.hmm.engine.ssv_score; an empty sequence
// scores NEG.
//
// Bound on the H100: operations.  Four float operations a DP cell
// (emission minus loop, entry max, add, running max) and one shared-memory
// read, ~450 Gcells per 3,000-protein genome against 2,766 Pfam-sized
// profiles: an SM reads 32 floats of shared memory a clock, one cell each,
// level with its float32 pipe at four operations a cell.  Device memory
// carries only the residues and one score a pair.
//
// Design: one warp scores one sequence against one profile, lane l owning
// the contiguous nodes [l*C, (l+1)*C) of the width class (C = width / 32)
// in registers.  A block holds its profile's 21 x width log-odds table in
// shared memory, lane-interleaved (node l*C + j at j*32 + l), so that the
// warp's 32 reads of one cell row fall in 32 banks whatever the residue;
// the block's warps take a tile of sequences in turn.  Per residue one
// __shfl_up_sync brings lane l-1's last old value for the node shift, the
// lane rewrites its nodes from the top down in place and keeps a running
// maximum of its own; SSV has no E or J state, so the only warp maximum is
// one a sequence, at its end, and no barrier runs inside the residue loop.
// The warp reads its sequence as aligned words that every lane loads from
// one address, the next word in flight (ResidueStream), so no shared read
// waits on a global load issued in the same step.  (Threads that each
// walk whole diagonals need no communication, but on the diagonals that
// start at node 0 the 32 lanes of a warp read 32 residues' rows at one
// bank, a ~16-way conflict on two thirds of the cells at Pfam sizes.)
//
// Nodes at or past the model length get NEG emissions: the shift runs
// towards higher nodes, so they never feed a real node, and node 0's
// predecessor is NEG.  Each cell computes (e - loop) + fmaxf(A, cb0) and
// the tail ((L * loop) + log 1/2) + move with round-to-nearest intrinsics,
// so the result equals the plain version bit for bit at any width.
//
// The 4,096-node class (C = 128; only profiles over 2,048 nodes) would not
// stay in registers and its table (344 KB) not in shared memory.  There
// (ssv_kernel_wide) lane l owns the nodes j*32 + l instead, so that a
// warp's 32 reads of the table row, through the read-only cache, are 32
// consecutive floats; A is double-buffered in shared memory, 32 KB a warp,
// the node shift a read of the old buffer, and one __syncwarp ends each
// residue; a block of four warps takes four sequences, so that one such
// profile still spreads over the card.  Walking the nodes in strips of
// 2,048 would carry a column of L floats a sequence from strip to strip,
// with no bound on L; the shared-memory state needs none and stays exact.
#include "common.cuh"

using namespace gecco;

namespace {

constexpr int SSV_WARPS = 8;
constexpr int SSV_THREADS = 32 * SSV_WARPS;
constexpr int SSV_SEQ_TILE = 32;
// the 4,096-node class: four warps, one sequence each
constexpr int WIDE_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

// the score of a sequence from its best cell: best + ((L * loop) + log 1/2)
// + move, rounded like the JAX kernel; NEG for an empty sequence
__device__ __forceinline__ float ssv_score(float best, int L, float loop, float move) {
    if (L == 0) return NEG;
    float c = __fmul_rn(static_cast<float>(L), loop);
    c = __fadd_rn(c, LOG_HALF);
    c = __fadd_rn(c, move);
    return __fadd_rn(best, c);
}

// C nodes a lane (C <= 64), width 32 * C, A in registers
template <int C>
__global__ void __launch_bounds__(SSV_THREADS)
ssv_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
           const int32_t* __restrict__ lens, const float* __restrict__ loops,
           const float* __restrict__ moves, int n_seqs,
           const float* __restrict__ e_log, const float* __restrict__ tbm,
           const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
           int P, int Mp, float* __restrict__ out) {
    constexpr int W = 32 * C;
    extern __shared__ float table[];  // [21][W], lane-interleaved

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int s0 = blockIdx.x * SSV_SEQ_TILE;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;

    for (int idx = threadIdx.x; idx < K_ALPHA * W; idx += SSV_THREADS) {
        const int a = idx / W;
        const int k = idx - a * W;
        const int owner = k / C;
        table[a * W + (k - owner * C) * 32 + owner] = k < M ? profile[a * plane + k] : NEG;
    }
    __syncthreads();

    const float tb = tbm[p];
    const int n_tile = min(SSV_SEQ_TILE, n_seqs - s0);
    for (int t = warp; t < n_tile; t += SSV_WARPS) {
        const int s = s0 + t;
        const int L = lens[s];
        const float loop = loops[s];
        const float cb0 = tb + moves[s];
        float A[C];
#pragma unroll
        for (int j = 0; j < C; ++j) A[j] = NEG;
        // two running maxima (max is exact in any order)
        float best0 = NEG, best1 = NEG;
        ResidueStream x(xs + offsets[s], L);
        for (int i = 0; i < L; ++i) {
            const float* row = table + x.next() * W + lane;
            float prev = __shfl_up_sync(FULL_MASK, A[C - 1], 1);
            if (lane == 0) prev = NEG;
#pragma unroll
            for (int j = C - 1; j >= 0; --j) {
                const float before = j > 0 ? A[j > 0 ? j - 1 : 0] : prev;
                const float a = (row[j * 32] - loop) + fmaxf(before, cb0);
                A[j] = a;
                if (j & 1) best1 = fmaxf(best1, a);
                else best0 = fmaxf(best0, a);
            }
        }
        const float best = warp_max_redux(fmaxf(best0, best1));
        if (lane == 0) out[static_cast<size_t>(s) * P + p] = ssv_score(best, L, loop, moves[s]);
    }
}

// C = 128 nodes a lane, width 4,096: lane l owns the nodes j*32 + l, so
// that a warp reads 32 consecutive floats of the table's row; A is double
// buffered in shared memory, [2][W] a warp, and a __syncwarp ends each
// residue
template <int C>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
ssv_kernel_wide(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
                const int32_t* __restrict__ lens, const float* __restrict__ loops,
                const float* __restrict__ moves, int n_seqs,
                const float* __restrict__ e_log, const float* __restrict__ tbm,
                const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
                int P, int Mp, float* __restrict__ out) {
    constexpr int W = 32 * C;
    extern __shared__ float state[];  // [WIDE_WARPS][2][W]

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int s = blockIdx.x * WIDE_WARPS + warp;
    if (s >= n_seqs) return;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;
    const int L = lens[s];
    const float loop = loops[s];
    const float cb0 = tbm[p] + moves[s];

    float* old = state + warp * 2 * W;
    float* cur = old + W;
#pragma unroll
    for (int j = 0; j < C; ++j) old[j * 32 + lane] = NEG;
    __syncwarp();
    float best0 = NEG, best1 = NEG;
    ResidueStream x(xs + offsets[s], L);
    for (int i = 0; i < L; ++i) {
        const float* row = profile + static_cast<size_t>(x.next()) * plane;
#pragma unroll
        for (int j = 0; j < C; ++j) {
            const int k = j * 32 + lane;
            const float e = k < M ? __ldg(row + k) : NEG;
            const float a = (e - loop) + fmaxf(k > 0 ? old[k - 1] : NEG, cb0);
            cur[k] = a;
            if (j & 1) best1 = fmaxf(best1, a);
            else best0 = fmaxf(best0, a);
        }
        __syncwarp();
        float* swap = old;
        old = cur;
        cur = swap;
    }
    const float best = warp_max_redux(fmaxf(best0, best1));
    if (lane == 0) out[static_cast<size_t>(s) * P + p] = ssv_score(best, L, loop, moves[s]);
}

template <int C>
cudaError_t launch(int n_seqs, int n_prof, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* e_log,
                   const void* tbm, const int32_t* prof_idx, const void* model_len, int P,
                   int Mp, void* out) {
    constexpr int W = 32 * C;
    constexpr bool WIDE = C > 64;
    const auto kernel = [] {
        if constexpr (WIDE) return ssv_kernel_wide<C>;
        else return ssv_kernel<C>;
    }();
    const size_t smem = sizeof(float) * (WIDE ? WIDE_WARPS * 2 * W : K_ALPHA * W);
    const int tile = WIDE ? WIDE_WARPS : SSV_SEQ_TILE;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (n_seqs + tile - 1) / tile;
    for (int y0 = 0; y0 < n_prof; y0 += 65535) {
        dim3 grid(tiles, min(65535, n_prof - y0));
        kernel<<<grid, WIDE ? 32 * WIDE_WARPS : SSV_THREADS, smem, st>>>(
            static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
            static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
            static_cast<const float*>(moves), n_seqs, static_cast<const float*>(e_log),
            static_cast<const float*>(tbm), prof_idx + y0,
            static_cast<const int32_t*>(model_len), P, Mp, static_cast<float*>(out));
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// Scores the profiles prof_idx[0..n_prof) (all of model length <= width, a
// power of two from 128 to 4,096) against every sequence; writes
// out[s * P + p].  Returns a CUDA error code.
extern "C" int gecco_ssv_filter(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, int n_seqs,
                                const void* e_log, const void* tbm, const void* prof_idx,
                                int n_prof, const void* model_len, int P, int Mp, int width,
                                void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* idx = static_cast<const int32_t*>(prof_idx);
#define GECCO_SSV_LAUNCH(C) \
    launch<C>(n_seqs, n_prof, st, xs, offsets, lens, loops, moves, e_log, tbm, idx, model_len, \
              P, Mp, out)
    cudaError_t err;
    switch (width) {
        case 128: err = GECCO_SSV_LAUNCH(4); break;
        case 256: err = GECCO_SSV_LAUNCH(8); break;
        case 512: err = GECCO_SSV_LAUNCH(16); break;
        case 1024: err = GECCO_SSV_LAUNCH(32); break;
        case 2048: err = GECCO_SSV_LAUNCH(64); break;
        case 4096: err = GECCO_SSV_LAUNCH(128); break;
        default: err = cudaErrorInvalidValue;
    }
#undef GECCO_SSV_LAUNCH
    return static_cast<int>(err);
}
