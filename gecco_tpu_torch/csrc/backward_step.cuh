// The rescaled Backward step shared by kernel E (stream_bwd.cu), kernels F
// and K (align_pass.cuh) and kernel J (pair_posterior.cu):
// gecco_tpu/hmm/stream.py:266-330 and :444-501, kernels.py:1877-1909.
//
// With e the emission odds of residue o+1 and the carries of o+1:
//
//   q_k = e_{k+1} bM_{k+1},   bB = sum_k bm_k e_k bM_k,
//   bJ = loop bJ + move bB,   bC = loop bC,   bN = loop bN + move bB,
//   bE = (bJ + bC) / 2,       bI_k = tim_k q_k + tii_k bI_k,
//   bD_k = nm_k bE + tdm_k q_k + tdd_k bD_{k+1},
//   bM_k = nm_k bE + tmm_k q_k + tmi_k bI_k + tmd_k bD_{k+1},
//
// every state divided by scale = bN + bJ + bC + bB + 1e-30, ls += log(scale).
// The row at o = L-1 is the initial one: bM = nm bE0 + tmd * bD_L (shifted),
// bE0 = move / 2, bC = move, the rest 0.
//
// The delete chain runs from the right and needs bE, which needs the
// block's sum bB.  Because the chain is linear in its input, bD = bE * U
// + V, where U (the chain of nm alone) is the same at every residue and is
// computed once into shared memory, and V (the chain of tdm * q) does not
// need bE: V's scan and bB's sum share one barrier.  Two barriers per
// residue: one hands each thread's first e*bM to its left neighbour, one
// publishes the warp totals of V's affine scan and of bB.
//
// warp_backward_step is the same step for one warp that holds a whole row
// (lane l holding nodes [l*C, (l+1)*C)): one shuffle hands lane l+1's first
// e*bM to lane l, bB is one warp sum, and V's offsets take a five-step
// shuffle scan from the right whose slopes (products of tdd, fixed by the
// profile) ChainScan holds, as chain_scan_right builds them: the mirror of
// warp_forward_step.  U is computed once per profile.  No barrier.
// Kernels E, F and J (up to 1,024 nodes) and K (128 and 256 nodes) use it;
// warp_posterior_row, the Backward of a row with its posteriors, is the
// whole Backward pass of kernels E and J.
#pragma once

#include "forward_step.cuh"

namespace gecco {

template <int THREADS>
struct BackwardScratch {
    float first[THREADS];  // e * bM at each thread's first node
    float a[THREADS / 32], b[THREADS / 32], s[THREADS / 32];
};

// Inclusive scan from the right, inside a warp, of the maps v -> ca*v + cb
// that carry the value entering a thread's chunk from the right to its
// left end.  (ia, ib): lanes lane..31 composed; (ea, eb): lanes lane+1..31
// (the identity at lane 31).
__device__ __forceinline__ void warp_scan_right(float ca, float cb, float& ia, float& ib,
                                                float& ea, float& eb) {
    const int lane = threadIdx.x & 31;
    ia = ca;
    ib = cb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float ya = __shfl_down_sync(0xffffffffu, ia, o);
        const float yb = __shfl_down_sync(0xffffffffu, ib, o);
        if (lane + o < 32) {
            ib = ia * yb + ib;
            ia = ia * ya;
        }
    }
    ea = __shfl_down_sync(0xffffffffu, ia, 1);
    eb = __shfl_down_sync(0xffffffffu, ib, 1);
    if (lane == 31) {
        ea = 1.0f;
        eb = 0.0f;
    }
}

// The Backward recurrence of one row: transitions `tsm` [N_TRANS][WIDTH],
// `nm` [WIDTH] (bank.e_odds[20], the node mask of the JAX kernels) and
// `U` [WIDTH + 1] in shared memory; the carries in registers.
template <int THREADS, int CHUNK>
struct Backward {
    static constexpr int WIDTH = THREADS * CHUNK;
    static constexpr int WARPS = THREADS / 32;

    const float* tsm;
    const float* nm;
    float* U;
    BackwardScratch<THREADS>& sh;
    float bM[CHUNK], bI[CHUNK];
    float bN, bJ, bC;
    double ls;  // the log scale, summed in double as warp_forward_traj's

    // U_k = nm_k + tdd_k U_{k+1}, U_WIDTH = 0 (ends with a barrier), then
    // the initial row.
    __device__ __forceinline__ void init(float move) {
        const float* tdd = tsm + T_DD * WIDTH;
        const float* tmd = tsm + T_MD * WIDTH;
        const int tid = threadIdx.x;
        const int warp = tid >> 5;
        const int base = tid * CHUNK;
        float ca = 1.0f, cb = 0.0f;
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            cb = nm[base + j] + tdd[base + j] * cb;
            ca = tdd[base + j] * ca;
        }
        float ia, ib, ea, eb;
        warp_scan_right(ca, cb, ia, ib, ea, eb);
        if ((tid & 31) == 0) {
            sh.a[warp] = ia;
            sh.b[warp] = ib;
        }
        __syncthreads();
        float X = 0.0f;
        for (int w = WARPS - 1; w > warp; --w) X = sh.a[w] * X + sh.b[w];
        float v = ea * X + eb;
        if (tid == THREADS - 1) U[WIDTH] = 0.0f;
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            v = nm[base + j] + tdd[base + j] * v;
            U[base + j] = v;
        }
        __syncthreads();
        const float bE0 = move * 0.5f;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            bM[j] = nm[k] * bE0 + tmd[k] * (bE0 * U[k + 1]);
            bI[j] = 0.0f;
        }
        bN = 0.0f;
        bJ = 0.0f;
        bC = move;
        ls = 0.0;
    }

    // One step to residue o from the carries of o+1, `e` the emission odds
    // of residue o+1; leaves the rescaled states of o in the carries and
    // returns the rescaled bB of o.
    __device__ __forceinline__ float step(const float* __restrict__ e, int M, float loop,
                                          float move) {
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

        float t[CHUNK];
        float bb = 0.0f;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            const float ek = k < M ? __ldg(e + k) : 0.0f;
            t[j] = ek * bM[j];
            bb += bm[k] * ek * bM[j];
        }
        sh.first[tid] = t[0];
        __syncthreads();
        const float next = tid + 1 < THREADS ? sh.first[tid + 1] : 0.0f;
        // V_k = tdm_k q_k + tdd_k V_{k+1}: this thread's composite
        float ca = 1.0f, cb = 0.0f;
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            const int k = base + j;
            const float q = j + 1 < CHUNK ? t[j + 1] : next;
            cb = tdm[k] * q + tdd[k] * cb;
            ca = tdd[k] * ca;
        }
        float ia, ib, ea, eb;
        warp_scan_right(ca, cb, ia, ib, ea, eb);
        const float ws = warp_sum(bb);
        if (lane == 0) {
            sh.a[warp] = ia;
            sh.b[warp] = ib;
            sh.s[warp] = ws;
        }
        __syncthreads();
        float X = 0.0f, Xw = 0.0f, bB = 0.0f;
        for (int w = WARPS - 1; w >= 0; --w) {
            if (w == warp) Xw = X;
            X = sh.a[w] * X + sh.b[w];
        }
        for (int w = 0; w < WARPS; ++w) bB += sh.s[w];

        const float bJn = loop * bJ + move * bB;
        const float bCn = loop * bC;
        const float bNn = loop * bN + move * bB;
        const float bEn = 0.5f * bJn + 0.5f * bCn;
        const float scale = bNn + bJn + bCn + bB + 1e-30f;
        const float inv = 1.0f / scale;
        float v = ea * Xw + eb;  // V at node base + CHUNK
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            const int k = base + j;
            const float q = j + 1 < CHUNK ? t[j + 1] : next;
            const float d_next = bEn * U[k + 1] + v;  // bD_{k+1}
            const float bIn = tim[k] * q + tii[k] * bI[j];
            const float bMn = nm[k] * bEn + tmm[k] * q + tmi[k] * bI[j] + tmd[k] * d_next;
            v = tdm[k] * q + tdd[k] * v;
            bM[j] = bMn * inv;
            bI[j] = bIn * inv;
        }
        bN = bNn * inv;
        bJ = bJn * inv;
        bC = bCn * inv;
        ls += logf(scale);
        return bB * inv;
    }
};

// ChainScan's mirror for chains that run from the right: a[k] is this
// lane's slope before step k of a scan that composes a lane's maps v ->
// tdd v + b with those of the lanes after it, or 0 where lane + 2^k does
// not exist.  Every lane of the warp builds it together, once per profile.
template <int C, typename Trans>
__device__ __forceinline__ ChainScan chain_scan_right(const Trans& tr) {
    const int lane = threadIdx.x & 31;
    float ca = 1.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) ca = tr(T_DD, j) * ca;
    ChainScan chain;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const int o = 1 << k;
        const float ya = __shfl_down_sync(0xffffffffu, ca, o);
        chain.a[k] = lane + o < 32 ? ca : 0.0f;
        if (lane + o < 32) ca = ca * ya;
    }
    return chain;
}

// The value entering this lane's last node from the right (0 at lane 31),
// given `cb`, the offset of this lane's maps composed: the offsets of the
// lanes after it composed by a five-step shuffle scan.
__device__ __forceinline__ float warp_chain_right(float cb, const ChainScan& chain) {
#pragma unroll
    for (int k = 0; k < 5; ++k) cb = chain.a[k] * __shfl_down_sync(0xffffffffu, cb, 1 << k) + cb;
    const float v = __shfl_down_sync(0xffffffffu, cb, 1);
    return (threadIdx.x & 31) == 31 ? 0.0f : v;
}

// A lane's values of N rows of a lane-interleaved table (row s, node l*C + j
// at (s*C + j)*32 + l; `p` at lane l): registers where REG, else reads of
// the shared table.
template <int C, int N, bool REG>
struct LaneRows {
    float t[N][C];
    __device__ __forceinline__ explicit LaneRows(const float* p) {
#pragma unroll
        for (int s = 0; s < N; ++s)
#pragma unroll
            for (int j = 0; j < C; ++j) t[s][j] = p[(s * C + j) * 32];
    }
    __device__ __forceinline__ float operator()(int s, int j) const { return t[s][j]; }
};

template <int C, int N>
struct LaneRows<C, N, false> {
    const float* p;
    __device__ __forceinline__ explicit LaneRows(const float* q) : p(q) {}
    __device__ __forceinline__ float operator()(int s, int j) const {
        return p[(s * C + j) * 32];
    }
};

// U_k = nm_k + tdd_k U_{k+1} (U_{32c} = 0) of a lane-interleaved table of
// c nodes a lane (transitions at `tsm`, nm at `nm`), written as U_{k+1} at
// node k of `u`: by one warp, every lane together; c is a run-time count.
__device__ __forceinline__ void warp_delete_basis(const float* tsm, const float* nm, float* u,
                                                  int c) {
    const int lane = threadIdx.x & 31;
    const float* tdd = tsm + T_DD * 32 * c;
    float ca = 1.0f, cb = 0.0f;
    for (int j = c - 1; j >= 0; --j) {
        cb = nm[j * 32 + lane] + tdd[j * 32 + lane] * cb;
        ca = tdd[j * 32 + lane] * ca;
    }
    float ia, ib, ea, eb;
    warp_scan_right(ca, cb, ia, ib, ea, eb);
    float v = eb;  // U at node (lane + 1) * c
    for (int j = c - 1; j >= 0; --j) {
        u[j * 32 + lane] = v;
        v = nm[j * 32 + lane] + tdd[j * 32 + lane] * v;
    }
}

// The initial Backward row of a warp (o = L-1): bM = nm bE0 + tmd bE0
// U_{k+1}, bE0 = move / 2, bI = 0; `nu(0, j)` is nm and `nu(1, j)` U_{k+1}.
template <int C, typename Trans, typename Nodes>
__device__ __forceinline__ void warp_backward_init(float (&bM)[C], float (&bI)[C], const Trans& tr,
                                                   const Nodes& nu, float move) {
    const float bE0 = move * 0.5f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        bM[j] = nu(0, j) * bE0 + tr(T_MD, j) * (bE0 * nu(1, j));
        bI[j] = 0.0f;
    }
}

// One Backward step of a warp over a whole row, to residue o from the
// carries of o+1: `e` the emission odds of residue o+1 at this lane's
// nodes, `tr` their transitions (both zero past the model length), `nu`
// nm and U_{k+1}, `right` chain_scan_right's slopes.  Leaves the rescaled
// states of o in the carries, adds log(scale) to ls (in double, as
// warp_forward_traj sums its log scale) and returns the rescaled bB of o.
template <int C, typename Trans, typename Nodes>
__device__ __forceinline__ float warp_backward_step(float (&bM)[C], float (&bI)[C], float& bN,
                                                    float& bJ, float& bC, double& ls,
                                                    const float (&e)[C], const Trans& tr,
                                                    const Nodes& nu, const ChainScan& right,
                                                    float loop, float move) {
    float t[C];
    float bb = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        t[j] = e[j] * bM[j];
        bb += tr(T_BM, j) * t[j];
    }
    float next = __shfl_down_sync(0xffffffffu, t[0], 1);
    if ((threadIdx.x & 31) == 31) next = 0.0f;
    // V_k = tdm_k q_k + tdd_k V_{k+1}: this lane's maps composed, then
    // the value entering the lane from the right
    float cb = 0.0f;
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
        const float q = j + 1 < C ? t[j + 1] : next;
        cb = tr(T_DM, j) * q + tr(T_DD, j) * cb;
    }
    float v = warp_chain_right(cb, right);
    const float bB = warp_sum(bb);

    const float bJn = loop * bJ + move * bB;
    const float bCn = loop * bC;
    const float bNn = loop * bN + move * bB;
    const float bEn = 0.5f * bJn + 0.5f * bCn;
    const float scale = bNn + bJn + bCn + bB + 1e-30f;
    const float inv = 1.0f / scale;
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
        const float q = j + 1 < C ? t[j + 1] : next;
        const float d_next = bEn * nu(1, j) + v;  // bD_{k+1}
        const float bIn = tr(T_IM, j) * q + tr(T_II, j) * bI[j];
        const float bMn = nu(0, j) * bEn + tr(T_MM, j) * q + tr(T_MI, j) * bI[j] +
                          tr(T_MD, j) * d_next;
        v = tr(T_DM, j) * q + tr(T_DD, j) * v;
        bM[j] = bMn * inv;
        bI[j] = bIn * inv;
    }
    bN = bNn * inv;
    bJ = bJn * inv;
    bC = bCn * inv;
    ls += logf(scale);
    return bB * inv;
}

// The Forward trajectories of one row, one value a residue: the rescaled
// N, B, J, C, E after each residue and the running log scale.  Kernel E
// reads them from device memory (kernel D's output, no fE); kernel J from
// its own scratch slice (warp form) or shared memory (block form).
struct ForwardTraj {
    const float *fN, *fB, *fJ, *fC, *fE, *flog;
};

// The posteriors of residue o from the Backward specials of o (rescaled,
// log scale ls) and the Forward trajectories of o and o-1 (N=1, J=C=0 and
// log scale 0 before the first residue); `total` is the Forward score:
//
//   ppX = fX(o-1) * loop * bX(o) * exp(fls(o-1) + bls(o) - total), X = N, J, C,
//   mocc(o) = clip(1 - ppN - ppJ - ppC, 0, 1),
//   pB(o) = fB(o) * bB(o) * exp(fls(o) + bls(o) - total),
//   pE(o) = fE(o) * bE(o) * exp(fls(o) + bls(o) - total), bE = (bJ + bC) / 2,
//
// pE only where `pe` is not null.  The exponents are summed in double.
__device__ __forceinline__ void emit_posterior(const ForwardTraj& f, int o, float loop,
                                               float total, float bN, float bB, float bJ,
                                               float bC, double ls, float* mocc, float* pb,
                                               float* pe) {
    const float pN = o > 0 ? f.fN[o - 1] : 1.0f;
    const float pJ = o > 0 ? f.fJ[o - 1] : 0.0f;
    const float pC = o > 0 ? f.fC[o - 1] : 0.0f;
    const float pls = o > 0 ? f.flog[o - 1] : 0.0f;
    const float sc_prev = expf(static_cast<float>(pls + ls - total));
    const float sc_cur = expf(static_cast<float>(f.flog[o] + ls - total));
    const float ppN = pN * loop * bN * sc_prev;
    const float ppJ = pJ * loop * bJ * sc_prev;
    const float ppC = pC * loop * bC * sc_prev;
    mocc[o] = fminf(fmaxf(1.0f - (ppN + ppJ + ppC), 0.0f), 1.0f);
    pb[o] = f.fB[o] * bB * sc_cur;
    if (pe != nullptr) pe[o] = f.fE[o] * (0.5f * bJ + 0.5f * bC) * sc_cur;
}

// The Backward of one row by one warp, C nodes a lane, with its posteriors
// (kernels E and J): from the initial row at o = L-1 down to o = 0 of the L
// residues of `xs`, `esm` the lane's emission-odds rows of a
// lane-interleaved table, `tr` its transitions, `nu` nm and U_{k+1},
// `right` chain_scan_right's slopes; `f` the row's Forward trajectories
// and `total` its Forward score.  Lane o mod 32 keeps residue o's bN, bB,
// bJ, bC and log scale; once every 32 residues each lane runs
// emit_posterior for its own residue, so that the trajectories at o and
// o-1 are read, and mocc, pB and pE (where `pe` is not null) stored, as 32
// consecutive floats a warp.  Then zeros from L to `stride`.
template <int C, typename Trans, typename Nodes>
__device__ __forceinline__ void warp_posterior_row(const int8_t* xs, int L, float loop, float move,
                                                   float total, const float* esm,
                                                   const Trans& tr, const Nodes& nu,
                                                   const ChainScan& right, const ForwardTraj& f,
                                                   float* mocc, float* pb, float* pe,
                                                   int stride) {
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    float bM[C], bI[C], e[C];
    warp_backward_init<C>(bM, bI, tr, nu, move);
    float bN = 0.0f, bB = 0.0f, bJ = 0.0f, bC = move;
    double ls = 0.0;
    // residue o's bN, bB, bJ, bC and log scale at lane o mod 32
    float kept[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    double kept_ls = 0.0;
    ResidueStreamRev x(xs, L);
    {
        const int x0 = L > 0 ? x.next() : 0;  // residue L-1, the first step's
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
    }
    for (int o = L - 1; o >= 0; --o) {
        if (o < L - 1) {
            // residue o's emissions, for the step to o - 1
            const int xn = o > 0 ? x.next() : 0;
            float en[C];
#pragma unroll
            for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
            bB = warp_backward_step<C>(bM, bI, bN, bJ, bC, ls, e, tr, nu, right, loop, move);
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
        }
        const int k = o & 31;
        if (lane == k) {
            kept[0] = bN;
            kept[1] = bB;
            kept[2] = bJ;
            kept[3] = bC;
            kept_ls = ls;
        }
        if (k == 0) {  // residues o .. min(o + 31, L - 1), one a lane
            const int mine = o + lane;
            if (mine < L)
                emit_posterior(f, mine, loop, total, kept[0], kept[1], kept[2], kept[3], kept_ls,
                               mocc, pb, pe);
        }
    }
    for (int o = L + lane; o < stride; o += 32) {
        mocc[o] = 0.0f;
        pb[o] = 0.0f;
        if (pe != nullptr) pe[o] = 0.0f;
    }
}

}  // namespace gecco
