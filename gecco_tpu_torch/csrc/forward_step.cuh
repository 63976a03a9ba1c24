// The rescaled Forward step (probability space) shared by kernel C
// (forward.cu, at 2,048 and 4,096 nodes), kernel D (stream_fwd.cu),
// kernels G and K (align_pass.cuh)
// and kernel J (pair_posterior.cu).
//
// One block scores one row; thread t holds nodes [t*CHUNK, (t+1)*CHUNK)
// in registers.  Per residue, with e the emission odds of the residue:
//
//   M_k = e_k * (stay_{k-1} + B * bm_k),
//   stay = M * tmm + I * tim + D * tdm,       I_k = M_k * tmi_k + I_k * tii_k,
//   D_k = D_{k-1} * tdd_{k-1} + M_{k-1} * tmd_{k-1},
//   E = sum_k (M_k + D_k); J, C, N, B of the multihit length model;
//   total = E + B + N + C + 1e-30, every state *= 1/total
//
// (gecco_tpu/hmm/stream.py:118-152).  The delete chain is computed exactly
// as a scan of affine maps D -> a*D + b across the nodes (thread-local,
// then a warp shuffle scan, then a pass over the warp totals); the E sum
// rides in the same pass, because each thread's share of sum_k D_k is
// itself affine in the value entering its warp.  Two barriers.
//
// warp_forward_step is the same step for one warp that holds a whole row
// (lane l holding nodes [l*C, (l+1)*C)): one shuffle hands the stay
// across lanes, the delete chain is the lane-local composition and a
// five-step shuffle scan of its offsets alone (the maps' slopes are
// products of tdd, fixed by the profile: ChainScan holds them), E one
// warp sum; no barrier.  Kernels C, D and J (up to 1,024 nodes), H, and G
// and K (128 and 256 nodes) use it; warp_forward_traj, the Forward of a
// row with its trajectories, is the whole Forward pass of kernels D and J.
#pragma once

#include "common.cuh"

namespace gecco {

// The transition planes of the bank, in its order.
enum { T_MM, T_IM, T_DM, T_MI, T_II, T_MD, T_DD, T_BM, N_TRANS };

template <int THREADS>
struct ForwardScratch {
    float stay[THREADS];
    float a[THREADS / 32], b[THREADS / 32], p[THREADS / 32], q[THREADS / 32];
};

// One Forward step over this thread's nodes; `tsm` holds the 8 transition
// planes [N_TRANS][WIDTH] (zero past M), `e` the emission odds of the
// residue (node 0, read for k < M).  Leaves the rescaled states in place,
// the rescaled E = sum_k (M_k + D_k) in `E_scaled` (kernel J records it),
// and returns the step's total.
template <int THREADS, int CHUNK>
__device__ __forceinline__ float forward_step(float (&Mv)[CHUNK], float (&Iv)[CHUNK],
                                              float (&Dv)[CHUNK], float& N, float& B, float& J,
                                              float& C, const float* __restrict__ e,
                                              const float* tsm, int M, float loop, float move,
                                              ForwardScratch<THREADS>& sh, float& E_scaled) {
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
        sh.stay[tid] = Mv[CHUNK - 1] * tmm[k] + Iv[CHUNK - 1] * tim[k] + Dv[CHUNK - 1] * tdm[k];
    }
    __syncthreads();
    const float prev = tid > 0 ? sh.stay[tid - 1] : 0.0f;
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
        const int k = base + j;
        const int q = j > 0 ? j - 1 : 0;  // node k-1 of this chunk
        const float stay = j > 0 ? Mv[q] * tmm[base + q] + Iv[q] * tim[base + q] +
                                       Dv[q] * tdm[base + q]
                                 : prev;
        if (k < M) {
            const float mn = __ldg(e + k) * (stay + B * bm[k]);
            Iv[j] = Mv[j] * tmi[k] + Iv[j] * tii[k];
            Mv[j] = mn;
        } else {
            Mv[j] = 0.0f;
            Iv[j] = 0.0f;
        }
    }
    // G_k = tdd_k * G_{k-1} + tmd_k * M_k is what node k sends on, and
    // D_k = G_{k-1}.  (ca, cb) composes this thread's maps; sum_D = sa *
    // G_in + sb is the thread's share of sum_k D_k.
    float ca = 1.0f, cb = 0.0f, sa = 0.0f, sb = 0.0f, sum_m = 0.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        const int k = base + j;
        sum_m += Mv[j];
        sa += ca;
        sb += cb;
        cb = tdd[k] * cb + tmd[k] * Mv[j];
        ca = tdd[k] * ca;
    }
    float ia = ca, ib = cb;  // warp-inclusive composite
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float ya = __shfl_up_sync(0xffffffffu, ia, o);
        const float yb = __shfl_up_sync(0xffffffffu, ib, o);
        if (lane >= o) {
            ib = ia * yb + ib;
            ia = ya * ia;
        }
    }
    float ea = __shfl_up_sync(0xffffffffu, ia, 1);
    float eb = __shfl_up_sync(0xffffffffu, ib, 1);
    if (lane == 0) {
        ea = 1.0f;
        eb = 0.0f;
    }
    const float pw = warp_sum(sa * ea);
    const float qw = warp_sum(sa * eb + sb + sum_m);
    if (lane == 31) {
        sh.a[warp] = ia;
        sh.b[warp] = ib;
    }
    if (lane == 0) {
        sh.p[warp] = pw;
        sh.q[warp] = qw;
    }
    __syncthreads();
    float X = 0.0f, mine = 0.0f, E = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) mine = X;
        E += sh.p[w] * X + sh.q[w];
        X = sh.a[w] * X + sh.b[w];
    }
    float g = ea * mine + eb;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        const int k = base + j;
        Dv[j] = k < M ? g : 0.0f;
        g = tdd[k] * g + tmd[k] * Mv[j];
    }
    const float Jn = J * loop + E * 0.5f;
    const float Cn = C * loop + E * 0.5f;
    const float Nn = N * loop;
    const float Bn = (Nn + Jn) * move;
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
    E_scaled = E * inv;
    return total;
}

// The same step for the kernels that do not record E.
template <int THREADS, int CHUNK>
__device__ __forceinline__ float forward_step(float (&Mv)[CHUNK], float (&Iv)[CHUNK],
                                              float (&Dv)[CHUNK], float& N, float& B, float& J,
                                              float& C, const float* __restrict__ e,
                                              const float* tsm, int M, float loop, float move,
                                              ForwardScratch<THREADS>& sh) {
    float unused;
    return forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop, move, sh, unused);
}

// Copy a profile's 8 transition rows and then its 21 emission-odds rows
// (bank planes of `plane` floats, the profile's row at `prow`) into
// dst[N_TRANS + K_ALPHA][32 * c], lane-interleaved for a warp whose lane l
// holds nodes [l*c, (l+1)*c): node l*c + j at j*32 + l, so that a warp's
// reads of one row fall in 32 banks; zero past the model length M.  Every
// thread of the block (`threads` of them) takes part; no barrier.  Kernels
// C, D, F and H stage their profile so.
__device__ __forceinline__ void stage_interleaved(float* dst, const float* trans,
                                                  const float* e_odds, size_t plane, size_t prow,
                                                  int M, int c, int threads) {
    const int W = 32 * c;
    for (int idx = threadIdx.x; idx < (N_TRANS + K_ALPHA) * W; idx += threads) {
        const int slot = idx / W;
        const int k = idx - slot * W;
        const int owner = k / c;
        const float* src = slot < N_TRANS ? trans + slot * plane
                                         : e_odds + (slot - N_TRANS) * plane;
        dst[slot * W + (k - owner * c) * 32 + owner] = k < M ? src[prow + k] : 0.0f;
    }
}

// A lane's transitions of its C nodes, tr(slot, j): held in registers
// (RegTrans) or read from a lane-interleaved [N_TRANS][32 * C] table in
// shared memory, node l*C + j at j*32 + l (SmemTrans, `p` at lane l).
template <int C>
struct RegTrans {
    float t[N_TRANS][C];
    __device__ __forceinline__ explicit RegTrans(const float* p) {
#pragma unroll
        for (int slot = 0; slot < N_TRANS; ++slot)
#pragma unroll
            for (int j = 0; j < C; ++j) t[slot][j] = p[(slot * C + j) * 32];
    }
    __device__ __forceinline__ float operator()(int slot, int j) const { return t[slot][j]; }
};

template <int C>
struct SmemTrans {
    const float* p;
    __device__ __forceinline__ explicit SmemTrans(const float* q) : p(q) {}
    __device__ __forceinline__ float operator()(int slot, int j) const {
        return p[(slot * C + j) * 32];
    }
};

// The slopes of a warp's delete-chain scan.  The chain passes G through
// each node's map G -> tdd_k G (+) tmd_k M_k, and the scan composes a
// lane's maps with those of the lanes before it, five shuffle steps of
// offset 2^k; a composite's slope is a product of tdd, the same at every
// residue.  a[k] is this lane's slope before step k, or 0 where lane -
// 2^k does not exist, so that the offset's update b = a[k] * b' (+) b
// leaves it as it is (b >= 0).  chain_scan builds it once per profile,
// every lane of the warp together.
struct ChainScan {
    float a[5];
};

template <int C, typename Trans>
__device__ __forceinline__ ChainScan chain_scan(const Trans& tr) {
    const int lane = threadIdx.x & 31;
    float ca = 1.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) ca = tr(T_DD, j) * ca;
    ChainScan chain;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const int o = 1 << k;
        const float ya = __shfl_up_sync(0xffffffffu, ca, o);
        chain.a[k] = lane >= o ? ca : 0.0f;
        if (lane >= o) ca = ya * ca;
    }
    return chain;
}

// One Forward step of a warp over a whole row.  Lane l holds nodes
// [l*C, (l+1)*C) of M, I and D, `e` their emission odds of the residue and
// `tr` their transitions; both are zero past the model length, so those
// nodes stay zero (node M's delete state is the plain version's
// tdd_{M-1} D_{M-1} + tmd_{M-1} M_{M-1}, zero in a Plan7 profile).  Every
// lane updates N, B, J and C, rescales its nodes and leaves the rescaled
// E = sum_k (M_k + D_k) in `E_scaled` (kernel J records it); returns the
// total.
template <int C, typename Trans>
__device__ __forceinline__ float warp_forward_step(float (&Mv)[C], float (&Iv)[C], float (&Dv)[C],
                                                   float& N, float& B, float& J, float& Cs,
                                                   const float (&e)[C], const Trans& tr,
                                                   const ChainScan& chain, float loop,
                                                   float move, float& E_scaled) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    float prev = __shfl_up_sync(FULL,
                                Mv[C - 1] * tr(T_MM, C - 1) + Iv[C - 1] * tr(T_IM, C - 1) +
                                    Dv[C - 1] * tr(T_DM, C - 1),
                                1);
    if (lane == 0) prev = 0.0f;
    // descending, so node j-1 still holds the previous row
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
        const int q = j > 0 ? j - 1 : 0;
        const float stay =
            j > 0 ? Mv[q] * tr(T_MM, q) + Iv[q] * tr(T_IM, q) + Dv[q] * tr(T_DM, q) : prev;
        const float mn = e[j] * (stay + B * tr(T_BM, j));
        Iv[j] = Mv[j] * tr(T_MI, j) + Iv[j] * tr(T_II, j);
        Mv[j] = mn;
    }
    // G_k = tdd_k * G_{k-1} + tmd_k * M_k is what node k sends on, and
    // D_k = G_{k-1}; cb is the offset of this lane's composed maps, then
    // of the lanes' up to this one
    float cb = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) cb = tr(T_DD, j) * cb + tr(T_MD, j) * Mv[j];
#pragma unroll
    for (int k = 0; k < 5; ++k) cb = chain.a[k] * __shfl_up_sync(FULL, cb, 1 << k) + cb;
    float g = __shfl_up_sync(FULL, cb, 1);
    if (lane == 0) g = 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        Dv[j] = g;
        sum += Mv[j] + g;
        g = tr(T_DD, j) * g + tr(T_MD, j) * Mv[j];
    }
    const float E = warp_sum(sum);
    const float Jn = J * loop + E * 0.5f;
    const float Cn = Cs * loop + E * 0.5f;
    const float Nn = N * loop;
    const float Bn = (Nn + Jn) * move;
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
    E_scaled = E * inv;
    return total;
}

// The same step for the kernels that do not record E.
template <int C, typename Trans>
__device__ __forceinline__ float warp_forward_step(float (&Mv)[C], float (&Iv)[C], float (&Dv)[C],
                                                   float& N, float& B, float& J, float& Cs,
                                                   const float (&e)[C], const Trans& tr,
                                                   const ChainScan& chain, float loop,
                                                   float move) {
    float unused;
    return warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move, unused);
}

// The Forward of one row by one warp, C nodes a lane, with its special-state
// trajectories (kernels D and J): the L residues of `xs` (length model loop,
// move), `esm` the lane's emission-odds rows of a lane-interleaved table,
// `tr` its transitions, `chain` their delete-chain slopes.  After residue i
// it records the rescaled N, B, J, C and the running log scale, and with
// NT = 6 the rescaled E, at traj[q * rows + i] for q = 0 .. NT-1.  Lane i
// mod 32 keeps residue i's values, and the warp stores 32 consecutive
// floats of each trajectory once every 32 residues (and the rest after the
// last one).  Returns the score log(C * move + 1e-38) + ls, the same in
// every lane (-1e30 for an empty sequence).  Nothing past L is written.
// The log scale is summed in double precision: outside a domain each
// residue adds a nearly constant small increment that rounds the same way
// in float32, which drifted by 0.04 nats over 4,700 residues, enough to
// move an envelope's end; it is stored rounded to float32.
template <int C, int NT, typename Trans>
__device__ __forceinline__ float warp_forward_traj(const int8_t* xs, int L, float loop,
                                                   float move, const float* esm,
                                                   const Trans& tr, const ChainScan& chain,
                                                   float* traj, size_t rows) {
    static_assert(NT == 5 || NT == 6, "N, B, J, C, log scale and perhaps E");
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    float Mv[C], Iv[C], Dv[C], e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = move, J = 0.0f, Cs = 0.0f, E = 0.0f;
    double ls = 0.0;
    float kept[NT];  // residue i's values at lane i mod 32
#pragma unroll
    for (int q = 0; q < NT; ++q) kept[q] = 0.0f;
    ResidueStream x(xs, L);
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
        ls += logf(warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move, E));
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = en[j];
        const int k = i & 31;
        if (lane == k) {
            kept[0] = N;
            kept[1] = B;
            kept[2] = J;
            kept[3] = Cs;
            kept[4] = static_cast<float>(ls);
            if constexpr (NT == 6) kept[5] = E;
        }
        if (k == 31 || i == L - 1) {  // residues i - k .. i, one a lane
            if (lane <= k) {
#pragma unroll
                for (int q = 0; q < NT; ++q) traj[q * rows + i - k + lane] = kept[q];
            }
        }
    }
    return L > 0 ? static_cast<float>(logf(Cs * move + 1e-38f) + ls) : NEG;
}

}  // namespace gecco
