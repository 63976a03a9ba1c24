// Kernel H: dense all-pairs Forward or Viterbi scores, every sequence
// against every profile of a width class.
//
// Replaces gecco_tpu/hmm/kernels.py:1051 _pallas_fwd (ForwardKernel and
// ViterbiKernel through Bucketed): the full-sequence score of each pair in
// nats, in probability space with a uniform rescale every residue,
//
//   M_k = e_k(x_i) (x) (stay_{k-1} (+) B * bm_k),
//   stay = M * tmm (+) I * tim (+) D * tdm,     I_k = M_k * tmi_k (+) I_k * tii_k,
//   D_k = D_{k-1} * tdd_{k-1} (+) M_{k-1} * tmd_{k-1},
//   J, C, N, B of the multihit length model,
//   total = E + B + N + C + 1e-30, every state *= 1/total, ls += log(total),
//
// and the score log(C * move + 1e-38) + ls after the last residue, with
// float32 subnormals flushed to zero as XLA flushes them (the TPU kernel
// in interpret mode): an empty sequence (C = 0) scores -inf.  (+) is + for Forward
// (sum-product, E = sum_k (M_k + D_k)) and max for Viterbi (max-plus,
// E = max_k M_k, kernels.py:1118-1124).  Both semirings run the exact
// delete chain over all nodes: the TPU kernel's dchain_depth truncation is
// not copied.
//
// Bound on the H100: issued instructions.  A DP cell is ~19 float
// operations (Forward; 18 for Viterbi) and the emission's shared read,
// and each pair is a serial chain over its residues.  Per residue a warp
// also issues a part that does not shrink with the nodes a lane: 12
// shuffles (one for the stay across lanes, five for the delete chain's
// scan, one to make it exclusive, five for the E sum; Viterbi takes E in
// one redux), the length model, a division, a log and the residue fetch;
// at a few nodes a lane it is as large as the cells' part.  Where
// transitions sit in shared memory (more than 8 nodes a lane) a cell
// takes nine shared reads, and one read instruction a clock an SM caps
// those profiles near 3.6 cells a clock.
//
// Design, widths 128 to 1,024: one warp scores one (sequence, profile)
// pair, lane l holding nodes [l*C, (l+1)*C) of M, I and D in registers,
// C = ceil(M / 32) for a profile of M nodes (each block runs the body of
// its profile's C, so that at most 31 nodes of a row are padding where a
// class-wide C = width / 32 would leave up to half of them; the class
// sets the registers).  One block per (profile, tile of `tile` sequences),
// the tiles of one profile in consecutive blocks so that its rows stay in
// L2; the block stages the profile's 8 transition rows and 21 emission-
// odds rows once, lane-interleaved (node l*C + j at j*32 + l) so that a
// warp's reads fall in 32 banks, and its warps take the tile's sequences
// from a shared counter (lengths vary, so a static split would leave
// warps idle).  At C <= 8 each lane also keeps its nodes' transitions in
// registers, and every lane keeps the slopes of its delete-chain scan
// (products of tdd, fixed by the profile: ChainScan), so that the scan
// shuffles the offsets alone.  Per residue: the residue comes from
// ResidueStream (aligned words, the next in flight) and the next
// residue's emissions are read from shared memory one step ahead; one
// __shfl_up_sync hands the last node's stay to lane l+1; the lane
// rewrites its nodes from the top down; the delete chain is the lane's
// composed map and a five-step shuffle scan; E is one warp reduction;
// every lane updates N, B, J and C and rescales its nodes itself.  No
// barrier runs inside the residue loop.  The Forward step is
// warp_forward_step (forward_step.cuh); the max-plus step below has the
// same shape with D -> max(a * D, b) maps and E the warp maximum of M.
// (The block design this replaces ran a block of width/4 threads per
// pair: two __syncthreads and a serial pass over the warps' totals a
// residue, one pair in flight per block, a dependent global residue load
// heading each residue, and the profile staged for 8 sequences.)
//
// Design, widths 2,048 and 4,096: one block per pair, each thread owning
// CHUNK consecutive nodes, the block-level steps (forward_step.cuh and
// block_viterbi_step below), two barriers a residue, the residues from
// ResidueStream.  64 or 128 nodes a lane of M, I and D would not stay in
// registers, and these classes hold 3 of 2,766 Pfam-sized profiles.
#include <cfloat>
#include <type_traits>

#include "forward_step.cuh"

using namespace gecco;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// warps a block: 4 where a lane's nodes and transitions take many
// registers in few nodes (C <= 8), 8 where the staged tables (116 bytes a
// node) leave room for few blocks an SM
template <int C>
constexpr int DENSE_WARPS = C <= 8 ? 4 : 8;
// blocks an SM the registers must leave room for: 24, 16, 16 and 8 warps.
// At widths 128 and 256 this caps the registers below what the compiler
// would take, at the cost of a few bytes of spill, and was faster on the
// H100 than more registers and fewer warps (PERF.md, kernel H's findings)
template <int C>
constexpr int DENSE_MIN_BLOCKS = C <= 4 ? 6 : C <= 8 ? 4 : C <= 16 ? 2 : 1;

// One max-plus step of a warp over a whole row; the arguments and the
// contract of warp_forward_step.
template <int C, typename Trans>
__device__ __forceinline__ float warp_viterbi_step(float (&Mv)[C], float (&Iv)[C], float (&Dv)[C],
                                                   float& N, float& B, float& J, float& Cs,
                                                   const float (&e)[C], const Trans& tr,
                                                   const ChainScan& chain, float loop,
                                                   float move) {
    const int lane = threadIdx.x & 31;
    float prev = __shfl_up_sync(
        FULL_MASK,
        fmaxf(fmaxf(Mv[C - 1] * tr(T_MM, C - 1), Iv[C - 1] * tr(T_IM, C - 1)),
              Dv[C - 1] * tr(T_DM, C - 1)),
        1);
    if (lane == 0) prev = 0.0f;
    // descending, so node j-1 still holds the previous row
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
        const int q = j > 0 ? j - 1 : 0;
        const float stay =
            j > 0 ? fmaxf(fmaxf(Mv[q] * tr(T_MM, q), Iv[q] * tr(T_IM, q)), Dv[q] * tr(T_DM, q))
                  : prev;
        const float mn = e[j] * fmaxf(stay, B * tr(T_BM, j));
        Iv[j] = fmaxf(Mv[j] * tr(T_MI, j), Iv[j] * tr(T_II, j));
        Mv[j] = mn;
    }
    // G_k = max(tdd_k * G_{k-1}, tmd_k * M_k) is what node k sends on, and
    // D_k = G_{k-1}; cb is the offset of this lane's composed maps
    // G -> max(a G, cb), then of the lanes' up to this one
    float cb = 0.0f, emax = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        emax = fmaxf(emax, Mv[j]);
        cb = fmaxf(tr(T_DD, j) * cb, tr(T_MD, j) * Mv[j]);
    }
    // the states are >= 0, so the ordered-bits maximum is exact
    const float E = warp_max_redux(emax);
#pragma unroll
    for (int k = 0; k < 5; ++k)
        cb = fmaxf(chain.a[k] * __shfl_up_sync(FULL_MASK, cb, 1 << k), cb);
    float g = __shfl_up_sync(FULL_MASK, cb, 1);
    if (lane == 0) g = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        Dv[j] = g;
        g = fmaxf(tr(T_DD, j) * g, tr(T_MD, j) * Mv[j]);
    }
    const float Jn = fmaxf(J * loop, E * 0.5f);
    const float Cn = fmaxf(Cs * loop, E * 0.5f);
    const float Nn = N * loop;
    const float Bn = fmaxf(Nn, Jn) * move;
    const float total = E + Bn + Nn + Cn + 1e-30f;
    const float inv = 1.0f / total;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        Mv[j] *= inv;
        Iv[j] *= inv;
        Dv[j] *= inv;
    }
    N = Nn * inv;
    B = Bn * inv;
    J = Jn * inv;
    Cs = Cn * inv;
    return total;
}

// The score of a pair after its last residue: log(C * move + 1e-38) + ls
// with subnormals flushed to zero, as XLA computes it.
__device__ __forceinline__ float final_score(float C, float move, float ls) {
    const float c = C * move;
    return logf(c >= FLT_MIN ? c : 0.0f) + ls;
}

// What a block's warps need to score their tile against its profile.
struct Tile {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const float* smem;  // the staged tables, 32 * C nodes a row
    int* next_seq;      // the block's shared counter
    int first, count;   // the tile's sequences
    int p, P;
    float* out;
};

// The tile's sequences against the block's profile, C nodes a lane, the
// warps taking sequences from the shared counter.  The block runs the
// body of C = ceil(M / 32) (C0 up to the class's CMAX), so that at most
// 31 nodes of a row are padding.
template <int C0, int CMAX, int VITERBI>
__device__ __forceinline__ void score_tile(int c, const Tile& t) {
    if constexpr (C0 < CMAX) {
        if (c > C0) {
            score_tile<C0 + 1, CMAX, VITERBI>(c, t);
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

    int r = threadIdx.x >> 5;
    while (r < t.count) {
        const int s = t.first + r;
        const int L = t.lens[s];
        const float loop = t.loops[s];
        const float move = t.moves[s];
        float Mv[C], Iv[C], Dv[C], e[C];
#pragma unroll
        for (int j = 0; j < C; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
        float N = 1.0f, B = move, J = 0.0f, Cs = 0.0f, ls = 0.0f;
        ResidueStream x(t.xs + t.offsets[s], L);
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
            float total;
            if constexpr (VITERBI) {
                total = warp_viterbi_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move);
            } else {
                total = warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move);
            }
            ls += logf(total);
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
        }
        if (lane == 0) t.out[static_cast<size_t>(s) * t.P + t.p] = final_score(Cs, move, ls);
        int taken = 0;
        if (lane == 0) taken = atomicAdd(t.next_seq, 1);
        r = __shfl_sync(FULL_MASK, taken, 0);
    }
}

// One block per (profile, tile of `tile` sequences) of a width class of
// 32 * CMAX nodes; profiles of M nodes run C = ceil(M / 32) nodes a lane
// (hmm.kernels.dense_nodes gives the host these counts).
template <int CMAX, int VITERBI>
__global__ void __launch_bounds__(32 * DENSE_WARPS<CMAX>, DENSE_MIN_BLOCKS<CMAX>)
dense_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
             const int32_t* __restrict__ lens, const float* __restrict__ loops,
             const float* __restrict__ moves, int n_seqs, int tile, int n_tiles,
             const float* __restrict__ e_odds, const float* __restrict__ trans,
             const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len, int P,
             int Mp, float* __restrict__ out) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = DENSE_WARPS<CMAX>;
    // [8][W] transitions, then [21][W] emission odds; lane-interleaved
    extern __shared__ float smem[];
    __shared__ int next_seq;

    // the tiles of one profile are consecutive blocks, so its rows stay
    // in L2 while they run
    const int first = (blockIdx.x % n_tiles) * tile;
    const int p = prof_idx[blockIdx.x / n_tiles];
    const int M = model_len[p];
    const int c = min(max((M + 31) / 32, CMIN), CMAX);
    stage_interleaved(smem, trans, e_odds, static_cast<size_t>(P) * Mp,
                      static_cast<size_t>(p) * Mp, M, c, 32 * WARPS);
    if (threadIdx.x == 0) next_seq = WARPS;
    __syncthreads();

    const Tile t{xs, offsets, lens, loops, moves, smem, &next_seq,
                 first, min(tile, n_seqs - first), p, P, out};
    score_tile<CMIN, CMAX, VITERBI>(c, t);
}

template <int THREADS>
struct ViterbiScratch {
    float stay[THREADS];
    float a[THREADS / 32], b[THREADS / 32], e[THREADS / 32];
};

// One max-plus step of a block over a row (widths 2,048 and 4,096); the
// arguments and the contract of forward_step.
template <int THREADS, int CHUNK>
__device__ __forceinline__ float block_viterbi_step(float (&Mv)[CHUNK], float (&Iv)[CHUNK],
                                                    float (&Dv)[CHUNK], float& N, float& B,
                                                    float& J, float& C,
                                                    const float* __restrict__ e,
                                                    const float* tsm, int M, float loop,
                                                    float move, ViterbiScratch<THREADS>& sh) {
    constexpr int WIDTH = THREADS * CHUNK;
    constexpr int WARPS = THREADS / 32;
    const float* tmm = tsm + T_MM * WIDTH;
    const float* tim = tsm + T_IM * WIDTH;
    const float* tdm = tsm + T_DM * WIDTH;
    const float* tmi = tsm + T_MI * WIDTH;
    const float* tii = tsm + T_II * WIDTH;
    const float* tmd = tsm + T_MD * WIDTH;
    const float* tdd = tsm + T_DD * WIDTH;
    const float* bm = tsm + T_BM * WIDTH;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int base = tid * CHUNK;

    {
        const int k = base + CHUNK - 1;
        sh.stay[tid] = fmaxf(fmaxf(Mv[CHUNK - 1] * tmm[k], Iv[CHUNK - 1] * tim[k]),
                             Dv[CHUNK - 1] * tdm[k]);
    }
    __syncthreads();
    const float prev = tid > 0 ? sh.stay[tid - 1] : 0.0f;
    // descending, so node j-1 still holds the previous row
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
        const int k = base + j;
        const int q = j > 0 ? j - 1 : 0;  // node k-1 of this chunk
        const float stay = j > 0 ? fmaxf(fmaxf(Mv[q] * tmm[base + q], Iv[q] * tim[base + q]),
                                         Dv[q] * tdm[base + q])
                                 : prev;
        if (k < M) {
            const float mn = __ldg(e + k) * fmaxf(stay, B * bm[k]);
            Iv[j] = fmaxf(Mv[j] * tmi[k], Iv[j] * tii[k]);
            Mv[j] = mn;
        } else {
            Mv[j] = 0.0f;
            Iv[j] = 0.0f;
        }
    }
    // G_k = max(tdd_k * G_{k-1}, tmd_k * M_k) is what node k sends on, and
    // D_k = G_{k-1}; (ca, cb) composes this thread's maps G -> max(ca G, cb).
    float ca = 1.0f, cb = 0.0f, emax = 0.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        const int k = base + j;
        emax = fmaxf(emax, Mv[j]);
        cb = fmaxf(tdd[k] * cb, tmd[k] * Mv[j]);
        ca = tdd[k] * ca;
    }
    float ia = ca, ib = cb;  // warp-inclusive composite
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float ya = __shfl_up_sync(FULL_MASK, ia, o);
        const float yb = __shfl_up_sync(FULL_MASK, ib, o);
        if (lane >= o) {
            ib = fmaxf(ia * yb, ib);
            ia = ya * ia;
        }
    }
    float ea = __shfl_up_sync(FULL_MASK, ia, 1);
    float eb = __shfl_up_sync(FULL_MASK, ib, 1);
    if (lane == 0) {
        ea = 1.0f;
        eb = 0.0f;
    }
    emax = warp_max(emax);
    if (lane == 31) {
        sh.a[warp] = ia;
        sh.b[warp] = ib;
    }
    if (lane == 0) sh.e[warp] = emax;
    __syncthreads();
    float X = 0.0f, mine = 0.0f, E = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) mine = X;
        E = fmaxf(E, sh.e[w]);
        X = fmaxf(sh.a[w] * X, sh.b[w]);
    }
    float g = fmaxf(ea * mine, eb);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        const int k = base + j;
        Dv[j] = k < M ? g : 0.0f;
        g = fmaxf(tdd[k] * g, tmd[k] * Mv[j]);
    }
    const float Jn = fmaxf(J * loop, E * 0.5f);
    const float Cn = fmaxf(C * loop, E * 0.5f);
    const float Nn = N * loop;
    const float Bn = fmaxf(Nn, Jn) * move;
    const float total = E + Bn + Nn + Cn + 1e-30f;
    const float inv = 1.0f / total;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        Mv[j] *= inv;
        Iv[j] *= inv;
        Dv[j] *= inv;
    }
    N = Nn * inv;
    B = Bn * inv;
    J = Jn * inv;
    C = Cn * inv;
    return total;
}

template <int THREADS, int CHUNK, int VITERBI>
__global__ void __launch_bounds__(THREADS)
dense_kernel_wide(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
                  const int32_t* __restrict__ lens, const float* __restrict__ loops,
                  const float* __restrict__ moves, int n_seqs, const float* __restrict__ e_odds,
                  const float* __restrict__ trans, const int32_t* __restrict__ prof_idx,
                  const int32_t* __restrict__ model_len, int P, int Mp,
                  float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ ViterbiScratch<THREADS> vsh;

    // the pairs of one profile are consecutive blocks, so its rows stay
    // in L2 while they run
    const int s = blockIdx.x % n_seqs;
    const int p = prof_idx[blockIdx.x / n_seqs];
    const int M = model_len[p];
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t row = static_cast<size_t>(p) * Mp;

    for (int idx = threadIdx.x; idx < N_TRANS * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        tsm[idx] = k < M ? trans[slot * plane + row + k] : 0.0f;
    }
    __syncthreads();

    const int L = lens[s];
    const float loop = loops[s];
    const float move = moves[s];
    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f, ls = 0.0f;
    ResidueStream x(xs + offsets[s], L);
    for (int i = 0; i < L; ++i) {
        const float* e = e_odds + static_cast<size_t>(x.next()) * plane + row;
        float total;
        if constexpr (VITERBI) {
            total = block_viterbi_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop,
                                                       move, vsh);
        } else {
            total = forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop, move,
                                                 fsh);
        }
        ls += logf(total);
    }
    if (threadIdx.x == 0) out[static_cast<size_t>(s) * P + p] = final_score(C, move, ls);
}

struct Args {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    int n_seqs;
    const float* e_odds;
    const float* trans;
    const int32_t* prof_idx;
    int n_prof;
    const int32_t* model_len;
    int P, Mp;
    float* out;
};

template <int C, int VITERBI>
cudaError_t launch_warps(const Args& a, int tile, cudaStream_t st) {
    const int n_tiles = (a.n_seqs + tile - 1) / tile;
    const long long blocks = static_cast<long long>(n_tiles) * a.n_prof;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * (N_TRANS + K_ALPHA) * 32 * C;
    cudaError_t err = allow_smem(dense_kernel<C, VITERBI>, smem);
    if (err != cudaSuccess) return err;
    dense_kernel<C, VITERBI><<<static_cast<unsigned>(blocks), 32 * DENSE_WARPS<C>, smem, st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.n_seqs, tile, n_tiles, a.e_odds, a.trans,
        a.prof_idx, a.model_len, a.P, a.Mp, a.out);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK, int VITERBI>
cudaError_t launch_wide(const Args& a, cudaStream_t st) {
    const long long blocks = static_cast<long long>(a.n_seqs) * a.n_prof;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * N_TRANS * THREADS * CHUNK;
    cudaError_t err = allow_smem(dense_kernel_wide<THREADS, CHUNK, VITERBI>, smem);
    if (err != cudaSuccess) return err;
    dense_kernel_wide<THREADS, CHUNK, VITERBI><<<static_cast<unsigned>(blocks), THREADS, smem,
                                                 st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.n_seqs, a.e_odds, a.trans, a.prof_idx,
        a.model_len, a.P, a.Mp, a.out);
    return cudaGetLastError();
}

template <int VITERBI>
cudaError_t launch(const Args& a, int width, int tile, cudaStream_t st) {
    switch (width) {
        case 128: return launch_warps<4, VITERBI>(a, tile, st);
        case 256: return launch_warps<8, VITERBI>(a, tile, st);
        case 512: return launch_warps<16, VITERBI>(a, tile, st);
        case 1024: return launch_warps<32, VITERBI>(a, tile, st);
        case 2048: return launch_wide<256, 8, VITERBI>(a, st);
        case 4096: return launch_wide<256, 16, VITERBI>(a, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Scores every sequence of the pack against the n_prof profiles prof_idx[],
// whose model lengths are all <= width (128, 256, ..., 4096): the Forward
// score (viterbi = 0) or the Viterbi score (viterbi != 0) of sequence s
// against profile p goes to out[s * P + p].  loops/moves are probabilities
// (exp of the length model).  Widths 128 to 1,024 give each block `tile`
// sequences of one profile (tile > 0); the wider classes take a block a
// pair and ignore it.  Returns a CUDA error code.
extern "C" int gecco_dense_scores(const void* xs, const void* offsets, const void* lens,
                                  const void* loops, const void* moves, int n_seqs,
                                  const void* e_odds, const void* trans, const void* prof_idx,
                                  int n_prof, const void* model_len, int P, int Mp, int width,
                                  int viterbi, int tile, void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const int8_t*>(xs),    static_cast<const int64_t*>(offsets),
                 static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
                 static_cast<const float*>(moves),  n_seqs,
                 static_cast<const float*>(e_odds), static_cast<const float*>(trans),
                 static_cast<const int32_t*>(prof_idx), n_prof,
                 static_cast<const int32_t*>(model_len), P, Mp, static_cast<float*>(out)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(viterbi ? launch<1>(a, width, tile, st)
                                    : launch<0>(a, width, tile, st));
}
