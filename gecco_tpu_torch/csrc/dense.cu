// Kernel H: dense all-pairs Forward or Viterbi scores, every sequence
// against every profile of a width class.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_fwd (ForwardKernel and
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
// Bound on the H100: the per-residue dependency chain of each pair (a
// serial DP over residues with a scan over the nodes inside each step);
// ~12 float operations and one emission read per DP cell.
//
// Design: one block per (profile, tile of TILE sequences), the profile's
// transitions staged in shared memory once per tile, emissions read by
// residue from the bank as kernel C reads them, and the tile's sequences
// walked one after another.  The sum-product step is forward_step.cuh
// (kernels C, D and G); the max-plus step below has the same shape: the
// delete chain is a scan of the maps D -> max(a * D, b) across the nodes
// (thread-local, a warp shuffle scan, a pass over the warp totals), exact
// prefix maxima, two barriers a residue.
#include <cfloat>

#include "forward_step.cuh"

using namespace gecco;

namespace {

constexpr int TILE = 8;  // sequences a block walks

template <int THREADS>
struct ViterbiScratch {
    float stay[THREADS];
    float a[THREADS / 32], b[THREADS / 32], e[THREADS / 32];
};

// One max-plus step in probability space over this thread's nodes; same
// arguments and contract as forward_step.
template <int THREADS, int CHUNK>
__device__ __forceinline__ float viterbi_step(float (&Mv)[CHUNK], float (&Iv)[CHUNK],
                                              float (&Dv)[CHUNK], float& N, float& B, float& J,
                                              float& C, const float* __restrict__ e,
                                              const float* tsm, int M, float loop, float move,
                                              ViterbiScratch<THREADS>& sh) {
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
        const float ya = __shfl_up_sync(0xffffffffu, ia, o);
        const float yb = __shfl_up_sync(0xffffffffu, ib, o);
        if (lane >= o) {
            ib = fmaxf(ia * yb, ib);
            ia = ya * ia;
        }
    }
    float ea = __shfl_up_sync(0xffffffffu, ia, 1);
    float eb = __shfl_up_sync(0xffffffffu, ib, 1);
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

template <int THREADS, int CHUNK, bool VITERBI>
__global__ void __launch_bounds__(THREADS)
dense_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
             const int32_t* __restrict__ lens, const float* __restrict__ loops,
             const float* __restrict__ moves, int n_seqs, int n_tiles,
             const float* __restrict__ e_odds, const float* __restrict__ trans,
             const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
             int P, int Mp, float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ ViterbiScratch<THREADS> vsh;

    // the tiles of one profile are consecutive blocks, so its rows stay
    // in L2 while they run
    const int tile = blockIdx.x % n_tiles;
    const int p = prof_idx[blockIdx.x / n_tiles];
    const int M = model_len[p];
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t row = static_cast<size_t>(p) * Mp;

    for (int idx = threadIdx.x; idx < N_TRANS * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        tsm[idx] = k < M ? trans[slot * plane + row + k] : 0.0f;
    }
    __syncthreads();

    const int s_end = min(n_seqs, (tile + 1) * TILE);
    for (int s = tile * TILE; s < s_end; ++s) {
        const int L = lens[s];
        const int8_t* x = xs + offsets[s];
        const float loop = loops[s];
        const float move = moves[s];
        float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
        float N = 1.0f, B = move, J = 0.0f, C = 0.0f, ls = 0.0f;
        for (int i = 0; i < L; ++i) {
            const float* e = e_odds + static_cast<size_t>(x[i]) * plane + row;
            float total;
            if constexpr (VITERBI) {
                total = viterbi_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop,
                                                     move, vsh);
            } else {
                total = forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop,
                                                     move, fsh);
            }
            ls += logf(total);
        }
        // log(C * move + 1e-38) with subnormals flushed to zero, as XLA does
        const float c = C * move;
        if (threadIdx.x == 0)
            out[static_cast<size_t>(s) * P + p] = logf(c >= FLT_MIN ? c : 0.0f) + ls;
    }
}

template <int THREADS, int CHUNK, bool VITERBI>
cudaError_t launch_one(unsigned blocks, int n_tiles, cudaStream_t st, const void* xs,
                       const void* offsets, const void* lens, const void* loops,
                       const void* moves, int n_seqs, const void* e_odds, const void* trans,
                       const void* prof_idx, const void* model_len, int P, int Mp, void* out) {
    const size_t smem = sizeof(float) * N_TRANS * THREADS * CHUNK;
    cudaError_t err = allow_smem(dense_kernel<THREADS, CHUNK, VITERBI>, smem);
    if (err != cudaSuccess) return err;
    dense_kernel<THREADS, CHUNK, VITERBI><<<blocks, THREADS, smem, st>>>(
        static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
        static_cast<const float*>(moves), n_seqs, n_tiles, static_cast<const float*>(e_odds),
        static_cast<const float*>(trans), static_cast<const int32_t*>(prof_idx),
        static_cast<const int32_t*>(model_len), P, Mp, static_cast<float*>(out));
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch(bool viterbi, unsigned blocks, int n_tiles, cudaStream_t st, const void* xs,
                   const void* offsets, const void* lens, const void* loops, const void* moves,
                   int n_seqs, const void* e_odds, const void* trans, const void* prof_idx,
                   const void* model_len, int P, int Mp, void* out) {
    return viterbi ? launch_one<THREADS, CHUNK, true>(blocks, n_tiles, st, xs, offsets, lens,
                                                      loops, moves, n_seqs, e_odds, trans,
                                                      prof_idx, model_len, P, Mp, out)
                   : launch_one<THREADS, CHUNK, false>(blocks, n_tiles, st, xs, offsets, lens,
                                                       loops, moves, n_seqs, e_odds, trans,
                                                       prof_idx, model_len, P, Mp, out);
}

}  // namespace

// Scores every sequence of the pack against the n_prof profiles prof_idx[],
// whose model lengths are all <= width (128, 256, ..., 4096): the Forward
// score (viterbi = 0) or the Viterbi score (viterbi != 0) of sequence s
// against profile p goes to out[s * P + p].  loops/moves are probabilities
// (exp of the length model).  Returns a CUDA error code.
extern "C" int gecco_dense_scores(const void* xs, const void* offsets, const void* lens,
                                  const void* loops, const void* moves, int n_seqs,
                                  const void* e_odds, const void* trans, const void* prof_idx,
                                  int n_prof, const void* model_len, int P, int Mp, int width,
                                  int viterbi, void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    const int n_tiles = (n_seqs + TILE - 1) / TILE;
    const long long blocks = static_cast<long long>(n_tiles) * n_prof;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C)                                                                     \
    launch<T, C>(viterbi != 0, static_cast<unsigned>(blocks), n_tiles, st, xs, offsets, lens, \
                 loops, moves, n_seqs, e_odds, trans, prof_idx, model_len, P, Mp, out)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
