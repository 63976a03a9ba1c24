// Kernel C: Forward (sum-product, probability space) scores of listed pairs.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_score with viterbi=False (the
// F3 Forward rescore of SearchPipeline.search, and the FORWARD tails of
// calibrate), and the pair kernels (kernels.py::_pallas_pair_fwd /
// _pallas_pair_fwd_ilp) that F3 fell back to for sequences longer than
// 4,096 residues.  The recurrence is stream.py:1117-1149 in probability
// space, rescaled every residue:
//
//   M_k = e_k(x_i) * (stay_{k-1} + B * bm_k),
//   stay = M * tmm + I * tim + D * tdm,       I_k = M_k * tmi_k + I_k * tii_k,
//   D_k = D_{k-1} * tdd_{k-1} + M_{k-1} * tmd_{k-1},
//   E = sum_k (M_k + D_k); J, C, N, B of the multihit length model;
//   total = E + B + N + C + 1e-30, every state *= 1/total, ls += log(total),
//
// and the score log(C * move + 1e-38) + ls after the last residue (an
// empty sequence scores -1e30).
//
// With per-row windows (`starts`, `ends`, 0-based half-open; null for the
// whole sequence) it also replaces kernels.py::_pallas_pair_fwd's
// envelope-window rescore (`ranges`): the recurrence starts afresh at
// residue `start`, runs to `end` and is read there, under the WHOLE
// sequence's loop and move.  An empty window scores -inf, as the TPU
// kernel's log(0 + 1e-38) does where 1e-38, a subnormal, is flushed.
//
// Bound on the H100: issued instructions.  A DP cell is ~19 float
// operations and the emission's shared read, and each pair is a serial
// chain over its residues; per residue a warp also issues a part that
// does not shrink with the nodes a lane (12 shuffles, the length model, a
// division, a log, the residue fetch).
//
// Design, widths 128 to 1,024 (as kernel H's, dense.cu): one warp scores
// one pair, lane l holding nodes [l*C, (l+1)*C) of M, I and D in
// registers, C = ceil(M / 32) for a profile of M nodes (each block runs
// the body of its profile's C; the class sets the registers).  The host
// orders the rows by width class and profile and hands each block a run
// of at most a few rows of ONE profile (`blocks`, hmm.kernels.pair_blocks,
// as kernel B takes them); the block stages that profile's 8 transition
// rows and 21 emission-odds rows once, lane-interleaved (node l*C + j at
// j*32 + l) so that a warp's reads fall in 32 banks, and its warps take
// the rows from a shared counter.  At C <= 8 each lane also keeps its
// nodes' transitions in registers, and every lane keeps the slopes of its
// delete-chain scan (ChainScan).  Per residue: the residue comes from
// ResidueStream (aligned words from the window's first residue, the next
// in flight) and the next residue's emissions are read from shared memory
// one step ahead; the step is warp_forward_step (forward_step.cuh): one
// shuffle hands the last node's stay to lane l+1, the delete chain is a
// five-step shuffle scan of the offsets, E one warp sum, and every lane
// updates N, B, J and C and rescales its nodes.  No barrier runs inside
// the residue loop.
//
// Design, widths 2,048 and 4,096: one block per pair (rows in the host's
// order), CHUNK consecutive nodes a thread, the block-level forward_step
// (two barriers a residue), the transitions staged in shared memory, the
// emissions read by residue from the bank tensor, the residues from
// ResidueStream.  64 or 128 nodes a lane of M, I and D would not stay in
// registers, and these classes hold 3 of 2,766 Pfam-sized profiles.
//
// Both designs read any sequence length.
#include <type_traits>

#include "forward_step.cuh"

using namespace gecco;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// warps a block and the blocks an SM the registers must leave room for,
// as kernel H's (dense.cu) at the same C
template <int C>
constexpr int FWD_WARPS = C <= 8 ? 4 : 8;
template <int C>
constexpr int FWD_MIN_BLOCKS = C <= 4 ? 6 : C <= 8 ? 4 : C <= 16 ? 2 : 1;

// The score of a row after its last residue (log(C * move + 1e-38) + ls),
// or that of an empty sequence or window.
__device__ __forceinline__ float forward_score(float C, float move, float ls, int L,
                                               bool windowed) {
    if (L == 0) return windowed ? -INFINITY : NEG;
    return logf(C * move + 1e-38f) + ls;
}

// What a block's warps need to score its run of rows.
struct Rows {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const int32_t* pair_seq;
    const int32_t* starts;  // null for whole sequences
    const int32_t* ends;
    const float* smem;      // the staged tables, 32 * C nodes a row
    int* next_row;          // the block's shared counter
    int first, count;
    float* out;
};

// The block's rows, C nodes a lane, the warps taking rows from the shared
// counter.  The block runs the body of C = ceil(M / 32) (C0 up to the
// class's CMAX).
template <int C0, int CMAX>
__device__ __forceinline__ void forward_rows(int c, const Rows& t) {
    if constexpr (C0 < CMAX) {
        if (c > C0) {
            forward_rows<C0 + 1, CMAX>(c, t);
            return;
        }
    }
    constexpr int C = C0;
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    const float* esm = t.smem + N_TRANS * W + lane;
    using Trans = std::conditional_t<(C <= 8), RegTrans<C>, SmemTrans<C>>;
    const Trans tr(t.smem + lane);
    const ChainScan chain = chain_scan<C>(tr);
    const bool windowed = t.starts != nullptr;

    int r = threadIdx.x >> 5;
    while (r < t.count) {
        const int row = t.first + r;
        const int s = t.pair_seq[row];
        const int start = windowed ? t.starts[row] : 0;
        const int L = windowed ? t.ends[row] - start : t.lens[s];
        const float loop = t.loops[s];
        const float move = t.moves[s];
        float Mv[C], Iv[C], Dv[C], e[C];
#pragma unroll
        for (int j = 0; j < C; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
        float N = 1.0f, B = move, J = 0.0f, Cs = 0.0f, ls = 0.0f;
        ResidueStream x(t.xs + t.offsets[s] + start, L);
        {
            const int x0 = L > 0 ? x.next() : 0;
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
        }
        for (int i = 0; i < L; ++i) {
            // the next residue's emissions, one step ahead
            const int xn = i + 1 < L ? x.next() : 0;
            float en[C];
#pragma unroll
            for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
            ls += logf(warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move));
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
        }
        if (lane == 0) t.out[row] = forward_score(Cs, move, ls, L, windowed);
        int taken = 0;
        if (lane == 0) taken = atomicAdd(t.next_row, 1);
        r = __shfl_sync(FULL_MASK, taken, 0);
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes; profiles of M nodes run
// C = ceil(M / 32) nodes a lane (hmm.kernels.dense_nodes).
template <int CMAX>
__global__ void __launch_bounds__(32 * FWD_WARPS<CMAX>, FWD_MIN_BLOCKS<CMAX>)
forward_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ lens, const float* __restrict__ loops,
               const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
               const int32_t* __restrict__ pair_prof, const float* __restrict__ e_odds,
               const float* __restrict__ trans, const int32_t* __restrict__ model_len, int P,
               int Mp, const int32_t* __restrict__ blocks, const int32_t* __restrict__ starts,
               const int32_t* __restrict__ ends, float* __restrict__ out) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = FWD_WARPS<CMAX>;
    // [8][W] transitions, then [21][W] emission odds; lane-interleaved
    extern __shared__ float smem[];
    __shared__ int next_row;

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = pair_prof[first];
    const int M = model_len[p];
    const int c = min(max((M + 31) / 32, CMIN), CMAX);
    stage_interleaved(smem, trans, e_odds, static_cast<size_t>(P) * Mp,
                      static_cast<size_t>(p) * Mp, M, c, 32 * WARPS);
    if (threadIdx.x == 0) next_row = WARPS;
    __syncthreads();

    const Rows t{xs, offsets, lens, loops, moves, pair_seq, starts, ends, smem, &next_row,
                 first, count, out};
    forward_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
forward_kernel_wide(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
                    const int32_t* __restrict__ lens, const float* __restrict__ loops,
                    const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
                    const int32_t* __restrict__ pair_prof, const float* __restrict__ e_odds,
                    const float* __restrict__ trans, const int32_t* __restrict__ model_len,
                    int P, int Mp, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ ends, float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ ForwardScratch<THREADS> sh;

    const int pair = blockIdx.x;
    const int s = pair_seq[pair];
    const int p = pair_prof[pair];
    const int M = model_len[p];
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t row = static_cast<size_t>(p) * Mp;

    for (int idx = threadIdx.x; idx < N_TRANS * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        tsm[idx] = k < M ? trans[slot * plane + row + k] : 0.0f;
    }
    __syncthreads();

    const bool windowed = starts != nullptr;
    const int start = windowed ? starts[pair] : 0;
    const int L = windowed ? ends[pair] - start : lens[s];
    const float loop = loops[s];
    const float move = moves[s];

    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f, ls = 0.0f;
    ResidueStream x(xs + offsets[s] + start, L);
    for (int i = 0; i < L; ++i) {
        const float* e = e_odds + static_cast<size_t>(x.next()) * plane + row;
        ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop, move, sh));
    }
    if (threadIdx.x == 0) out[pair] = forward_score(C, move, ls, L, windowed);
}

struct Args {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const int32_t* pair_seq;
    const int32_t* pair_prof;
    const float* e_odds;
    const float* trans;
    const int32_t* model_len;
    int P, Mp;
    const int32_t* starts;
    const int32_t* ends;
    float* out;
};

template <int C>
cudaError_t launch_warps(const Args& a, const int32_t* blocks, int n_blocks, cudaStream_t st) {
    const size_t smem = sizeof(float) * (N_TRANS + K_ALPHA) * 32 * C;
    cudaError_t err = allow_smem(forward_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    forward_kernel<C><<<n_blocks, 32 * FWD_WARPS<C>, smem, st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.pair_seq, a.pair_prof, a.e_odds, a.trans,
        a.model_len, a.P, a.Mp, blocks, a.starts, a.ends, a.out);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const Args& a, int n_pairs, cudaStream_t st) {
    const size_t smem = sizeof(float) * N_TRANS * THREADS * CHUNK;
    cudaError_t err = allow_smem(forward_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    forward_kernel_wide<THREADS, CHUNK><<<n_pairs, THREADS, smem, st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.pair_seq, a.pair_prof, a.e_odds, a.trans,
        a.model_len, a.P, a.Mp, a.starts, a.ends, a.out);
    return cudaGetLastError();
}

}  // namespace

// Scores n_pairs (pair_seq[r], pair_prof[r]) pairs whose profiles all have
// model length <= width (128, 256, ..., 4096); loops/moves are probabilities
// (exp of the length model).  blocks [n_blocks][2] int32 (first row, row
// count) cut the rows into runs of one profile each, one block a run
// (hmm.kernels.pair_blocks); widths 2048 and 4096 ignore it and take one
// block a row.  starts/ends [n_pairs] int32 are the rows' residue windows
// (0 <= start <= end <= length), or both null for whole sequences.  Writes
// out[r]; returns a CUDA error code.
extern "C" int gecco_forward_pairs(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* pair_seq,
                                   const void* pair_prof, int n_pairs, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, const void* blocks, int n_blocks,
                                   const void* starts, const void* ends, void* out,
                                   void* stream) {
    if (n_pairs <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Args a{static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
                 static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
                 static_cast<const float*>(moves), static_cast<const int32_t*>(pair_seq),
                 static_cast<const int32_t*>(pair_prof), static_cast<const float*>(e_odds),
                 static_cast<const float*>(trans), static_cast<const int32_t*>(model_len),
                 P, Mp, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
                 static_cast<float*>(out)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 1024 && (runs == nullptr || n_blocks <= 0)) return cudaErrorInvalidValue;
    cudaError_t err;
    switch (width) {
        case 128: err = launch_warps<4>(a, runs, n_blocks, st); break;
        case 256: err = launch_warps<8>(a, runs, n_blocks, st); break;
        case 512: err = launch_warps<16>(a, runs, n_blocks, st); break;
        case 1024: err = launch_warps<32>(a, runs, n_blocks, st); break;
        case 2048: err = launch_wide<256, 8>(a, n_pairs, st); break;
        case 4096: err = launch_wide<256, 16>(a, n_pairs, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
