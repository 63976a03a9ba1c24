// Kernel I: MSV filter scores of every (sequence, profile) pair.
//
// Replaces gecco_tpu/hmm/kernels.py:273 _pallas_msv (the F1 filter of
// SearchPipeline(filter_stage="msv"), HMMER 3.0's multi-segment filter).
// For each pair it returns, in nats, C + move after the last residue of
//
//   M_k(i) = e_k(x_i) + max(M_{k-1}(i-1), B(i-1) + tbm)     (M_{-1} = NEG)
//   E(i)   = max_k M_k(i)
//   J(i)   = max(J(i-1) + loop, E(i) + log 1/2),  C(i) likewise
//   N(i)   = N(i-1) + loop,  B(i) = max(N(i), J(i)) + move
//
// from M = NEG, N = 0, B = move, J = C = NEG, with the additions in the
// TPU kernel's order (the host oracle is gecco_tpu.hmm.engine.msv_score).
// An empty sequence scores NEG.  J and C run the same recurrence from the
// same start, so C equals J bit for bit: the kernel keeps J alone and
// scores J + move.
//
// Bound on the H100: operations.  Three float operations per DP cell
// (emission add, entry max, running max of E) and one shared-memory
// read; ~450 Gcells per 3,000-protein genome against 2,766 Pfam-sized
// profiles.  The only device-memory traffic is the residues (L1-resident)
// and one score per pair.  Per residue a warp also issues a part that
// does not shrink with the nodes a lane (the node shift, E, the length
// model, the residue): at a few nodes a lane it is as large as the cells'.
//
// Design: unlike SSV (kernel A, ssv.cu), the J loop couples every node
// of a row: E(i) is a maximum over all nodes and B(i) enters every node
// of row i+1, so the diagonals cannot run apart.  Up to 2,048 nodes G
// lanes of a warp score one sequence against one profile, and a warp
// scores 32 / G sequences side by side: G = 4, 8 and 16 lanes at 128,
// 256 and 512 nodes, 32 above (MSV_LANES).  Lane q of a sequence's G owns
// the contiguous nodes [q*C, (q+1)*C) in registers, C = ceil(M / G) for a
// profile of M nodes up to 1,024 (each block runs the body of its
// profile's C, so that at most G - 1 nodes of a row are padding; the
// class sets the registers), C = 64 at 2,048 nodes.  Fewer lanes a
// sequence share the part of a residue that does not shrink with the
// nodes a lane among more sequences: at 128 nodes it costs as much as the
// cells.  A block holds its profile's 21-row log-odds table in shared
// memory, lane-interleaved (node q*C + j at j*G + q, rows padded to whole
// 32-bank lines), one copy for each sequence of a warp, copy g starting
// g*G banks on, so that the warp's reads of its sequences' residues' rows
// fall in 32 distinct banks whatever the residues.  The block's warps
// take the sequences of a tile, 32 / G at a time, from a shared counter;
// the host orders the sequences longest first (hmm.kernels.SeqPack.
// by_length), so that a warp's and a tile's sequences are of about one
// length, and scores go to each sequence's own row.  Per residue the
// residue comes from ResidueStream (aligned words, the next in flight)
// and, up to 1,024 nodes, the next residue's table row is read one step
// ahead; one __shfl_up_sync (width G) brings lane q-1's last old M for the
// node shift, each lane rewrites its nodes from the top down in place, E
// is the maximum of the lane maxima (one redux at G = 32, log2(G)
// __shfl_xor_sync steps below), and every lane updates N, J and B itself:
// no barrier inside the residue loop.  A warp runs to its longest
// sequence; a shorter one reads its score after its last residue.
//
// At 4,096 nodes (msv_kernel_wide) 128 nodes a lane would not stay in
// registers and the table (344 KB) not in shared memory.  There lane l
// owns the nodes j*32 + l, j < ceil(M / 32), so that a warp's 32 reads of
// the table row, through the read-only cache, are 32 consecutive floats;
// M is double-buffered in shared memory, 32 KB a warp, the node shift a
// read of the old buffer; E is one redux maximum and one __syncwarp ends
// each residue; a block of four warps takes four sequences.
//
// Nodes at or past the model length get NEG emissions: the shift runs
// towards higher nodes, so they never feed a real node, and node 0's
// predecessor is NEG.  Each cell and the length model use round-to-nearest
// intrinsics, and maxima are exact in any order, so the result equals the
// plain version bit for bit at any width; the TPU kernel's lane-0 mask has
// no counterpart here.
#include "common.cuh"

using namespace gecco;

namespace {

constexpr int MSV_WARPS = 8;
constexpr int MSV_THREADS = 32 * MSV_WARPS;
// sequences a block takes (hmm.kernels.MSV_TILE)
constexpr int MSV_TILE = 32;
// the 4,096-node class: four warps, one sequence each
constexpr int WIDE_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

// lanes a sequence in the class of 32 * CMAX nodes (32 / G sequences a
// warp side by side), and the nodes a lane at the class's width
template <int CMAX>
constexpr int MSV_LANES = CMAX == 4 ? 4 : CMAX == 8 ? 8 : CMAX == 16 ? 16 : 32;
template <int CMAX>
constexpr int MSV_NODES = 32 * CMAX / MSV_LANES<CMAX>;
// sequences a block of the class takes: MSV_TILE, or a take of every warp
template <int CMAX>
constexpr int MSV_TILE_OF = MSV_TILE > MSV_WARPS * 32 / MSV_LANES<CMAX>
                                ? MSV_TILE : MSV_WARPS * 32 / MSV_LANES<CMAX>;
// blocks an SM the registers must leave room for
template <int CMAX>
constexpr int MSV_MIN_BLOCKS = MSV_NODES<CMAX> <= 8 ? 4 : MSV_NODES<CMAX> <= 16 ? 3
                               : MSV_NODES<CMAX> <= 32 ? 2 : 1;

// E from the lane maxima of a sequence's G lanes, then J, N and B of the
// length model, in the plain version's order of additions (every lane
// alike)
template <int G>
__device__ __forceinline__ void msv_specials(float lane_max, float loop, float move, float& N,
                                             float& B, float& J) {
    float E;
    if constexpr (G == 32) {
        E = warp_max_redux(lane_max);
    } else {
        E = lane_max;
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) E = fmaxf(E, __shfl_xor_sync(FULL_MASK, E, o, G));
    }
    J = fmaxf(__fadd_rn(J, loop), __fadd_rn(E, LOG_HALF));
    N = __fadd_rn(N, loop);
    B = __fadd_rn(fmaxf(N, J), move);
}

// What a block's warps need to score their tile against its profile.
struct Tile {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const int32_t* order;  // the pack's sequences, longest first
    const float* table;    // the staged tables (msv_table_stride)
    int* next_seq;         // the block's shared counter
    int first, count;      // the tile's slots of `order`
    int p, P;
    float tb;
    float* out;
};

// Row stride of a staged table of G lanes of c nodes (whole rows of 32
// banks), and the offset of the copy that the sequence g of a warp reads:
// copy g starts g * G banks on, so that the warp's 32 / G sequences read
// their own residues' rows in distinct banks
__host__ __device__ constexpr int msv_table_stride(int G, int c) {
    return (G * c + 31) / 32 * 32;
}
__host__ __device__ constexpr int msv_copy_offset(int G, int c, int g) {
    return g * (K_ALPHA * msv_table_stride(G, c) + G);
}

// The tile's sequences against the block's profile, G lanes a sequence
// and C nodes a lane in registers, the warps taking 32 / G sequences at a
// time from the shared counter.  The block runs the body of its
// profile's C (C0 up to the class's CMAX).  The warp runs to the longest
// of its sequences; a shorter one reads its score after its last residue
// and runs on with residue 0 (its stream stops at its last residue).
template <int G, int C0, int CMAX>
__device__ __forceinline__ void msv_tile(int c, const Tile& t) {
    if constexpr (C0 < CMAX) {
        if (c > C0) {
            msv_tile<G, C0 + 1, CMAX>(c, t);
            return;
        }
    }
    constexpr int C = C0;
    constexpr int SPW = 32 / G;
    constexpr int W = msv_table_stride(G, C);
    // the next residue's row one step ahead, where its registers fit
    constexpr bool AHEAD = C <= 32;
    const int lane = threadIdx.x & 31;
    const int g = lane / G;
    const int q = lane % G;
    const float* tsm = t.table + msv_copy_offset(G, C, g) + q;

    int r = (threadIdx.x >> 5) * SPW;
    while (r < t.count) {
        const bool live = r + g < t.count;
        const int s = live ? t.order[t.first + r + g] : 0;
        const int L = live ? t.lens[s] : 0;
        const float loop = t.loops[s];
        const float move = t.moves[s];
        const int steps = SPW > 1 ? static_cast<int>(__reduce_max_sync(FULL_MASK, L)) : L;
        float Mv[C], e[AHEAD ? C : 1];
#pragma unroll
        for (int j = 0; j < C; ++j) Mv[j] = NEG;
        float N = 0.0f, B = move, J = NEG, score = NEG;
        ResidueStream x(t.xs + t.offsets[s], L);
        int xi = L > 0 ? x.next() : 0;
        if constexpr (AHEAD) {
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = tsm[xi * W + j * G];
        }
        // two residues an iteration below G = 32: faster at 128 to 512
        // nodes, slower at 1,024 (more registers), on the H100
#pragma unroll (G < 32 ? 2 : 1)
        for (int i = 0; i < steps; ++i) {
            const int xn = i + 1 < L ? x.next() : 0;
            float en[AHEAD ? C : 1];
            if constexpr (AHEAD) {
#pragma unroll
                for (int j = 0; j < C; ++j) en[j] = tsm[xn * W + j * G];
            }
            const float bt = __fadd_rn(B, t.tb);
            float prev = __shfl_up_sync(FULL_MASK, Mv[C - 1], 1, G);
            if (q == 0) prev = NEG;
            // descending, so node j-1 still holds the previous row; two
            // running maxima of E (max is exact in any order)
            float E0 = NEG, E1 = NEG;
#pragma unroll
            for (int j = C - 1; j >= 0; --j) {
                const float before = j > 0 ? Mv[j > 0 ? j - 1 : 0] : prev;
                const float ej = AHEAD ? e[AHEAD ? j : 0] : tsm[xi * W + j * G];
                const float mn = __fadd_rn(ej, fmaxf(before, bt));
                Mv[j] = mn;
                if (j & 1) E1 = fmaxf(E1, mn);
                else E0 = fmaxf(E0, mn);
            }
            msv_specials<G>(fmaxf(E0, E1), loop, move, N, B, J);
            if (i == L - 1) score = __fadd_rn(J, move);
            if constexpr (AHEAD) {
#pragma unroll
                for (int j = 0; j < C; ++j) e[j] = en[j];
            }
            xi = xn;
        }
        if (live && q == 0) t.out[static_cast<size_t>(s) * t.P + t.p] = score;
        int taken = 0;
        if (lane == 0) taken = atomicAdd(t.next_seq, SPW);
        r = __shfl_sync(FULL_MASK, taken, 0);
    }
}

// One block per (tile of MSV_TILE_OF sequences, profile) of a width class of
// 32 * CMAX nodes (up to 2,048); a sequence takes G = MSV_LANES lanes, and
// profiles of M nodes run ceil(M / G) nodes a lane up to 1,024 nodes
// (hmm.kernels.msv_nodes), 64 at 2,048.
template <int CMAX>
__global__ void __launch_bounds__(MSV_THREADS, MSV_MIN_BLOCKS<CMAX>)
msv_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
           const int32_t* __restrict__ lens, const float* __restrict__ loops,
           const float* __restrict__ moves, int n_seqs, const int32_t* __restrict__ order,
           const float* __restrict__ e_log, const float* __restrict__ tbm,
           const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
           int P, int Mp, float* __restrict__ out) {
    constexpr int G = MSV_LANES<CMAX>;
    constexpr int CS = MSV_NODES<CMAX>;
    // the narrowest class holds every model length up to its width, the
    // others those above half their width; 2,048 nodes run one body
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX > 32 ? CS : CS / 2 + 1;
    extern __shared__ float table[];  // 32 / G copies of [21][stride], lane-interleaved
    __shared__ int next_seq;

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int c = min(max((M + G - 1) / G, CMIN), CS);
    const int W = msv_table_stride(G, c);
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;

    // node k = o * c + j of copy g at j * G + o of its row
    for (int idx = threadIdx.x; idx < (32 / G) * K_ALPHA * G * c; idx += MSV_THREADS) {
        const int g = idx / (K_ALPHA * G * c);
        const int rest = idx - g * (K_ALPHA * G * c);
        const int a = rest / (G * c);
        const int k = rest - a * (G * c);
        const int owner = k / c;
        table[msv_copy_offset(G, c, g) + a * W + (k - owner * c) * G + owner] =
            k < M ? profile[a * plane + k] : NEG;
    }
    if (threadIdx.x == 0) next_seq = MSV_WARPS * (32 / G);
    __syncthreads();

    const int first = blockIdx.x * MSV_TILE_OF<CMAX>;
    const Tile t{xs, offsets, lens, loops, moves, order, table, &next_seq,
                 first, min(MSV_TILE_OF<CMAX>, n_seqs - first), p, P, tbm[p], out};
    msv_tile<G, CMIN, CS>(c, t);
}

// C = 128, width 4,096: lane l owns the nodes j*32 + l (j < ceil(M / 32)),
// so that a warp reads 32 consecutive floats of the table's row; M is
// double buffered in shared memory, [2][W] a warp, and a __syncwarp ends
// each residue
template <int C>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
msv_kernel_wide(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
                const int32_t* __restrict__ lens, const float* __restrict__ loops,
                const float* __restrict__ moves, int n_seqs, const int32_t* __restrict__ order,
                const float* __restrict__ e_log, const float* __restrict__ tbm,
                const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
                int P, int Mp, float* __restrict__ out) {
    constexpr int W = 32 * C;
    extern __shared__ float state[];  // [WIDE_WARPS][2][W]

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int nc = (M + 31) / 32;  // nodes a lane runs
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int slot = blockIdx.x * WIDE_WARPS + warp;
    if (slot >= n_seqs) return;
    const int s = order[slot];
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;
    const int L = lens[s];
    const float loop = loops[s];
    const float move = moves[s];
    const float tb = tbm[p];

    float* old = state + warp * 2 * W;
    float* cur = old + W;
    for (int j = 0; j < nc; ++j) old[j * 32 + lane] = NEG;
    __syncwarp();
    float N = 0.0f, B = move, J = NEG;
    ResidueStream x(xs + offsets[s], L);
    for (int i = 0; i < L; ++i) {
        const float* row = profile + static_cast<size_t>(x.next()) * plane;
        const float bt = __fadd_rn(B, tb);
        float E0 = NEG, E1 = NEG;
#pragma unroll 4
        for (int j = 0; j < nc; ++j) {
            const int k = j * 32 + lane;
            const float e = k < M ? __ldg(row + k) : NEG;
            const float mn = __fadd_rn(e, fmaxf(k > 0 ? old[k - 1] : NEG, bt));
            cur[k] = mn;
            if (j & 1) E1 = fmaxf(E1, mn);
            else E0 = fmaxf(E0, mn);
        }
        msv_specials<32>(fmaxf(E0, E1), loop, move, N, B, J);
        __syncwarp();
        float* swap = old;
        old = cur;
        cur = swap;
    }
    if (lane == 0) out[static_cast<size_t>(s) * P + p] = L > 0 ? __fadd_rn(J, move) : NEG;
}

template <int C>
cudaError_t launch(int n_seqs, int n_prof, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* order,
                   const void* e_log, const void* tbm, const int32_t* prof_idx,
                   const void* model_len, int P, int Mp, void* out) {
    constexpr int W = 32 * C;
    constexpr bool WIDE = C > 64;
    const auto kernel = [] {
        if constexpr (WIDE) return msv_kernel_wide<C>;
        else return msv_kernel<C>;
    }();
    constexpr int G = MSV_LANES<C>;
    const size_t smem = sizeof(float) * (WIDE ? WIDE_WARPS * 2 * W
                                              : msv_copy_offset(G, MSV_NODES<C>, 32 / G));
    const int tile = WIDE ? WIDE_WARPS : MSV_TILE_OF<C>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (n_seqs + tile - 1) / tile;
    for (int y0 = 0; y0 < n_prof; y0 += 65535) {
        dim3 grid(tiles, min(65535, n_prof - y0));
        kernel<<<grid, WIDE ? 32 * WIDE_WARPS : MSV_THREADS, smem, st>>>(
            static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
            static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
            static_cast<const float*>(moves), n_seqs, static_cast<const int32_t*>(order),
            static_cast<const float*>(e_log), static_cast<const float*>(tbm), prof_idx + y0,
            static_cast<const int32_t*>(model_len), P, Mp, static_cast<float*>(out));
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// Scores the profiles prof_idx[0..n_prof) (all of model length <= width, a
// power of two from 128 to 4,096) against every sequence; `order` [n_seqs]
// int32 is the sequences longest first, the order in which blocks take
// them.  Writes out[s * P + p].  Returns a CUDA error code.
extern "C" int gecco_msv_filter(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, int n_seqs,
                                const void* order, const void* e_log, const void* tbm,
                                const void* prof_idx, int n_prof, const void* model_len, int P,
                                int Mp, int width, void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* idx = static_cast<const int32_t*>(prof_idx);
#define GECCO_MSV_LAUNCH(C) \
    launch<C>(n_seqs, n_prof, st, xs, offsets, lens, loops, moves, order, e_log, tbm, idx, \
              model_len, P, Mp, out)
    cudaError_t err;
    switch (width) {
        case 128: err = GECCO_MSV_LAUNCH(4); break;
        case 256: err = GECCO_MSV_LAUNCH(8); break;
        case 512: err = GECCO_MSV_LAUNCH(16); break;
        case 1024: err = GECCO_MSV_LAUNCH(32); break;
        case 2048: err = GECCO_MSV_LAUNCH(64); break;
        case 4096: err = GECCO_MSV_LAUNCH(128); break;
        default: err = cudaErrorInvalidValue;
    }
#undef GECCO_MSV_LAUNCH
    return static_cast<int>(err);
}
