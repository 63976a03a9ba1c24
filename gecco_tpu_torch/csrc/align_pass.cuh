// The two passes of envelope alignment, shared by kernels F and G
// (align_bwd.cu, align_fwd.cu: one pass a kernel, the parked rows in device
// memory between them) and kernel K (pair_align.cu: both passes in one
// block, the parked rows in a scratch slice only that block touches).
//
// park_backward runs the Backward recurrence of backward_step.cuh from the
// row's last residue down to residue `lo` and parks, for residues lo..hi:
//
//   pM[o][k] = bM_k, pI[o][k] = bI_k   (bfloat16, rounded to nearest even as
//     astype(bfloat16) does),
//   blog[o] = ls, bNl/bJl/bCl[o] = log(bX + 1e-38) + ls for X = N, J, C
//     (at o = L-1: -1e30, -1e30, log(move)).
//
// align_forward walks residues i = 1 .. jv of envelope [iv, jv] (1-based
// inclusive; `total` the pair's Forward score):
//
//   * the full-sequence Forward step (forward_step.cuh) and, inside the
//     envelope, the posteriors ppM = M bM exp(fls + bls - total), ppI
//     likewise, from the parked bfloat16 planes and log scale, and
//     ppN + ppJ + ppC from the Forward specials before the step and the
//     parked log specials; matocc, insocc (per node) and xocc sum them;
//   * inside the envelope, the envelope's own Forward (length model
//     Ld/(Ld+3), Ld = jv - iv + 1), whose score is
//     envsc = log(C * 3/(Ld+3) + 1e-38) + its log scale;
//   * inside the envelope, the optimal-accuracy DP of
//     gecco_tpu/hmm/stream.py:730-791 (kernels.py:2299-2367) with start
//     payloads (start residue, start node): predecessor max(fromM, fromI,
//     fromD) with priority M, I, D on ties; a new start where that max <= 0;
//     the insert prefers M on ties; in the delete chain a farther node wins
//     only if strictly greater; the best cell updates on a strictly greater
//     row max, at the lowest node holding it;
//
// and at the end the 21 null2 log-ratios log((matocc . e_a + insocc + xocc)
// / (sum matocc + insocc + xocc)).  Outputs: out[r] = [envsc, 21 logs],
// coords[r] = [target from, target to, hmm from, hmm to].  Past jv nothing
// reported changes, so the pass stops there; below iv only the Forward runs.
//
// The OA payloads travel as one int32, start residue * 8192 + start node.
// The delete chain is a max-plus scan: node k sends H_k = max(sM_k + g_md_k,
// H_{k-1} + g_dd_k) (the carry only if strictly greater) and sD_{k+1} = H_k;
// a chunk's maps compose to x -> (x + g > V ? x + g : V), which a warp
// shuffle scan and a pass over the warp totals combine with the same tie
// rule.  Five barriers a residue inside the envelope (two per Forward, one
// for the delete max-scan and the row max), two outside it.
//
// warp_park_backward and warp_align_forward are the same passes for one
// warp that holds a whole row (lane l holding nodes [l*C, (l+1)*C)), with
// no barrier: the Backward step is warp_backward_step, the Forward step
// warp_forward_step, the old row's last node reaches the next lane by a
// shuffle, the delete max-scan is the warp's shuffle scan alone and the
// row max a butterfly; the envelope's own Forward is a pass of its own
// (warp_envelope_forward), since it needs only the residues.  Kernels F
// (park) and G (align) run them in one kernel each, kernel K both in one
// warp.  Both forms take each node's OA cells (oa_cells) and delete chain
// step (delete_map, apply) from the functions below, so that the tie rules
// exist once.
#pragma once

#include <cuda_bf16.h>

#include "backward_step.cuh"

namespace gecco {

constexpr float TINY = 1e-38f;
constexpr int PAY = 8192;  // payload = start residue * PAY + start node

// Max-plus map x -> (x + g > v ? x + g : v) with v's payload p.
struct MaxMap {
    float g, v;
    int p;
};

// f2 after f1.
__device__ __forceinline__ MaxMap compose(const MaxMap& f1, const MaxMap& f2) {
    const float moved = f1.v + f2.g;
    MaxMap out;
    out.g = f1.g + f2.g;
    if (moved > f2.v) {
        out.v = moved;
        out.p = f1.p;
    } else {
        out.v = f2.v;
        out.p = f2.p;
    }
    return out;
}

__device__ __forceinline__ void apply(const MaxMap& f, float& x, int& px) {
    const float moved = x + f.g;
    if (!(moved > f.v)) {
        x = f.v;
        px = f.p;
    } else {
        x = moved;
    }
}

__device__ __forceinline__ float gate(float t) { return t > 0.0f ? 0.0f : NEG; }

// The map a node applies to the delete chain: H_k = max(sM_k + g_md_k,
// H_{k-1} + g_dd_k), the carry only if strictly greater.
__device__ __forceinline__ MaxMap delete_map(float g_dd, float sM, float g_md, int qM) {
    return MaxMap{g_dd, sM + g_md, qM};
}

// One node's optimal-accuracy match and insert cells.  sM, sI (and their
// payloads qM, qI) hold the node's old row on entry and its new row on
// return; fromM, fromI, fromD are node k-1's old-row values plus their
// gates (payM, payI, payD their payloads); g_mi, g_ii the node's own
// gates, node_neg 0 or NEG (the node mask), ppM, ppI its posteriors and
// `start` the payload of a new start here.  Predecessor priority M, I, D
// on ties; a new start where that max <= 0; the insert prefers M on ties.
__device__ __forceinline__ void oa_cells(float& sM, float& sI, int& qM, int& qI, float fromM,
                                         float fromI, float fromD, int payM, int payI,
                                         int payD, float g_mi, float g_ii, float node_neg,
                                         float ppM, float ppI, int start) {
    const float pmax = fmaxf(fromM, fmaxf(fromI, fromD));
    const bool useM = fromM >= pmax;
    const bool useI = !useM && fromI >= pmax;
    const float fromMi = sM + g_mi;
    const float fromIi = sI + g_ii;
    const bool useMi = fromMi >= fromIi;
    const int payIn = useMi ? qM : qI;
    sI = (node_neg + ppI) + fmaxf(fromMi, fromIi);
    qI = payIn;
    sM = (node_neg + ppM) + fmaxf(pmax, 0.0f);
    qM = pmax <= 0.0f ? start : (useM ? payM : (useI ? payI : payD));
}

// The inclusive max-plus scan of a warp's maps (lane 0 first) and its
// exclusive form, what enters each lane (the identity at lane 0).
__device__ __forceinline__ MaxMap warp_delete_scan(const MaxMap& f) {
    MaxMap inc = f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        MaxMap left;
        left.g = __shfl_up_sync(0xffffffffu, inc.g, o);
        left.v = __shfl_up_sync(0xffffffffu, inc.v, o);
        left.p = __shfl_up_sync(0xffffffffu, inc.p, o);
        if ((threadIdx.x & 31) >= o) inc = compose(left, inc);
    }
    return inc;
}

__device__ __forceinline__ MaxMap warp_exclusive(const MaxMap& inc) {
    MaxMap exc;
    exc.g = __shfl_up_sync(0xffffffffu, inc.g, 1);
    exc.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
    exc.p = __shfl_up_sync(0xffffffffu, inc.p, 1);
    if ((threadIdx.x & 31) == 0) exc = MaxMap{0.0f, -INFINITY, -1};
    return exc;
}

// The row max over a warp with its lowest node and that node's payload,
// every lane left with the same.
__device__ __forceinline__ void warp_row_max(float& rmax, int& rk, int& rp) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, rmax, o);
        const int ok = __shfl_xor_sync(0xffffffffu, rk, o);
        const int op = __shfl_xor_sync(0xffffffffu, rp, o);
        if (ov > rmax || (ov == rmax && ok < rk)) {
            rmax = ov;
            rk = ok;
            rp = op;
        }
    }
}

// A null2 log-ratio, log((matocc . e_a + insocc + xocc) / (sum matocc +
// insocc + xocc)), in float32: log(max(n2, 1e-300)), where 1e-300 rounds to 0.
__device__ __forceinline__ float null2_ratio(float dot, float mat, float ins, float xocc) {
    const float inv_tot = 1.0f / fmaxf(mat + ins + xocc, 1e-30f);
    return logf(fmaxf((dot + ins + xocc) * inv_tot, 0.0f));
}

template <int THREADS>
struct AlignScratch {
    // the OA state a thread's last node hands to the next thread's first
    float fm[THREADS], fi[THREADS], fd[THREADS];
    int pm[THREADS], pi[THREADS], pd[THREADS];
    // warp totals of the delete max-scan and of the row max
    float dg[THREADS / 32], dv[THREADS / 32], mv[THREADS / 32];
    int dp[THREADS / 32], mk[THREADS / 32], mp[THREADS / 32];
    float red[THREADS / 32][23];
};

// The parked Backward rows of one envelope row: residue o (0-based) is at
// index o - origin of each array.  Kernels F and G park whole sequences
// (origin 0); kernel K parks the envelope's residues only.
template <typename Plane, typename Scalar>
struct ParkedRows {
    Plane *pM, *pI;                   // [rows][width] bfloat16
    Scalar *blog, *bNl, *bJl, *bCl;   // [rows]
    int origin;
    size_t width;                     // a parked row's nodes, at least the block's
};
using ParkedOut = ParkedRows<__nv_bfloat16, float>;
using ParkedIn = ParkedRows<const __nv_bfloat16, const float>;

// Backward from the row's last residue down to `lo`, parking residues
// lo..hi (0-based).  Every thread of the block calls it; `U` [THREADS *
// CHUNK + 1] is its delete-chain basis (backward_step.cuh).
template <int THREADS, int CHUNK>
__device__ __forceinline__ void park_backward(const RowArgs& a, const Row& row, const float* tsm,
                                              const float* nm, float* U,
                                              BackwardScratch<THREADS>& sh,
                                              const ParkedOut& parked, int lo, int hi) {
    const int base = threadIdx.x * CHUNK;
    Backward<THREADS, CHUNK> bw{tsm, nm, U, sh};
    bw.init(row.move);
    for (int o = row.L - 1; o >= lo; --o) {
        const bool init = o == row.L - 1;
        if (!init) bw.step(emission_row(a.e_odds, row, o + 1), row.M, row.loop, row.move);
        if (o > hi) continue;
        const int at = o - parked.origin;
        __nv_bfloat16* m = parked.pM + static_cast<size_t>(at) * parked.width + base;
        __nv_bfloat16* ins = parked.pI + static_cast<size_t>(at) * parked.width + base;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            m[j] = __float2bfloat16_rn(bw.bM[j]);
            ins[j] = __float2bfloat16_rn(bw.bI[j]);
        }
        if (threadIdx.x == 0) {
            parked.blog[at] = static_cast<float>(bw.ls);
            parked.bNl[at] = init ? NEG : static_cast<float>(logf(bw.bN + TINY) + bw.ls);
            parked.bJl[at] = init ? NEG : static_cast<float>(logf(bw.bJ + TINY) + bw.ls);
            parked.bCl[at] = init ? logf(row.move) : static_cast<float>(logf(bw.bC + TINY) + bw.ls);
        }
    }
}

// The alignment Forward pass of envelope row r.  `tsm` [N_TRANS][WIDTH] and
// `nm` [WIDTH] are staged, `matocc` and `insocc` [WIDTH] zeroed, before a
// barrier; thread t reads nodes [t*CHUNK, (t+1)*CHUNK) of the parked planes.
template <int THREADS, int CHUNK, typename Parked>
__device__ __forceinline__ void align_forward(const RowArgs& a, const Row& row, int r,
                                              const float* tsm, const float* nm, float* matocc,
                                              float* insocc, ForwardScratch<THREADS>& fsh,
                                              AlignScratch<THREADS>& ash, const Parked& parked,
                                              int iv, int jv, float total,
                                              float* __restrict__ out,
                                              int32_t* __restrict__ coords) {
    constexpr int WIDTH = THREADS * CHUNK;
    constexpr int WARPS = THREADS / 32;
    const float* tmm = tsm + T_MM * WIDTH;
    const float* tim = tsm + T_IM * WIDTH;
    const float* tdm = tsm + T_DM * WIDTH;
    const float* tmi = tsm + T_MI * WIDTH;
    const float* tii = tsm + T_II * WIDTH;
    const float* tmd = tsm + T_MD * WIDTH;
    const float* tdd = tsm + T_DD * WIDTH;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int base = tid * CHUNK;
    const float loop = row.loop;
    const float move = row.move;
    const float log_loop = logf(loop);
    const float Ld = fmaxf(static_cast<float>(jv - iv) + 1.0f, 1.0f);
    const float eloop = Ld / (Ld + 3.0f);
    const float emove = 3.0f / (Ld + 3.0f);
    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];      // full-sequence Forward
    float eM[CHUNK], eI[CHUNK], eD[CHUNK];      // envelope Forward
    float sM[CHUNK], sI[CHUNK], sD[CHUNK];      // optimal accuracy
    int qM[CHUNK], qI[CHUNK], qD[CHUNK];        // their start payloads
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
        Mv[j] = Iv[j] = Dv[j] = eM[j] = eI[j] = eD[j] = 0.0f;
        sM[j] = sI[j] = sD[j] = NEG;
        qM[j] = qI[j] = qD[j] = -1;
    }
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f;
    float eN = 1.0f, eB = emove, eJ = 0.0f, eC = 0.0f;
    double lsf = 0.0, elog = 0.0;  // log scales, summed in double as warp_forward_traj's
    float xocc = 0.0f, best = NEG;
    int b_pay = 0, b_row = 0, b_node = 0;

    for (int i = 0; i < jv; ++i) {
        const float* e = emission_row(a.e_odds, row, i);
        if (i + 1 < iv) {
            lsf += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M,
                                                     loop, move, fsh));
            continue;
        }
        const int at = i - parked.origin;  // the residue's parked row
        // special-state posteriors from the Forward values before the step
        const float ppN =
            expf(static_cast<float>(logf(N + TINY) + lsf + log_loop + parked.bNl[at] - total));
        const float ppJ =
            expf(static_cast<float>(logf(J + TINY) + lsf + log_loop + parked.bJl[at] - total));
        const float ppC =
            expf(static_cast<float>(logf(C + TINY) + lsf + log_loop + parked.bCl[at] - total));
        xocc += fminf(fmaxf(ppN + ppJ + ppC, 0.0f), 1.0f);
        {   // OA values this thread's last node hands on (old row)
            const int k = base + CHUNK - 1;
            ash.fm[tid] = sM[CHUNK - 1] + gate(tmm[k]);
            ash.fi[tid] = sI[CHUNK - 1] + gate(tim[k]);
            ash.fd[tid] = sD[CHUNK - 1] + gate(tdm[k]);
            ash.pm[tid] = qM[CHUNK - 1];
            ash.pi[tid] = qI[CHUNK - 1];
            ash.pd[tid] = qD[CHUNK - 1];
        }
        lsf += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M, loop,
                                                 move, fsh));
        const float pscale = expf(static_cast<float>(lsf + parked.blog[at] - total));
        elog += logf(forward_step<THREADS, CHUNK>(eM, eI, eD, eN, eB, eJ, eC, e, tsm, row.M,
                                                  eloop, emove, fsh));

        // optimal accuracy: match and insert cells, nodes high to low so
        // that node k-1 still holds the old row
        const float in_fm = tid > 0 ? ash.fm[tid - 1] : NEG;
        const float in_fi = tid > 0 ? ash.fi[tid - 1] : NEG;
        const float in_fd = tid > 0 ? ash.fd[tid - 1] : NEG;
        const int in_pm = tid > 0 ? ash.pm[tid - 1] : -1;
        const int in_pi = tid > 0 ? ash.pi[tid - 1] : -1;
        const int in_pd = tid > 0 ? ash.pd[tid - 1] : -1;
        const size_t node = static_cast<size_t>(at) * parked.width + base;
        const __nv_bfloat16* rowM = parked.pM + node;
        const __nv_bfloat16* rowI = parked.pI + node;
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            const int k = base + j;
            const float ppM = Mv[j] * __bfloat162float(rowM[j]) * pscale;
            const float ppI = Iv[j] * __bfloat162float(rowI[j]) * pscale;
            matocc[k] += ppM;
            insocc[k] += ppI;
            const float fromM = j > 0 ? sM[j - 1] + gate(tmm[k - 1]) : in_fm;
            const float fromI = j > 0 ? sI[j - 1] + gate(tim[k - 1]) : in_fi;
            const float fromD = j > 0 ? sD[j - 1] + gate(tdm[k - 1]) : in_fd;
            const int payM = j > 0 ? qM[j - 1] : in_pm;
            const int payI = j > 0 ? qI[j - 1] : in_pi;
            const int payD = j > 0 ? qD[j - 1] : in_pd;
            oa_cells(sM[j], sI[j], qM[j], qI[j], fromM, fromI, fromD, payM, payI, payD,
                     gate(tmi[k]), gate(tii[k]), nm[k] > 0.0f ? 0.0f : NEG, ppM, ppI,
                     (i + 1) * PAY + (k + 1));
        }
        // delete chain (max-plus scan) and the row max with its lowest node
        MaxMap f{0.0f, -INFINITY, -1};
        float rmax = -INFINITY;
        int rk = 0, rp = -1;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            f = compose(f, delete_map(gate(tdd[k]), sM[j], gate(tmd[k]), qM[j]));
            if (sM[j] > rmax) {
                rmax = sM[j];
                rk = k;
                rp = qM[j];
            }
        }
        const MaxMap inc = warp_delete_scan(f);
        const MaxMap exc = warp_exclusive(inc);
        warp_row_max(rmax, rk, rp);
        if (lane == 31) {
            ash.dg[warp] = inc.g;
            ash.dv[warp] = inc.v;
            ash.dp[warp] = inc.p;
        }
        if (lane == 0) {
            ash.mv[warp] = rmax;
            ash.mk[warp] = rk;
            ash.mp[warp] = rp;
        }
        __syncthreads();
        float x = NEG;
        int px = -1;
        for (int w = 0; w < warp; ++w) apply(MaxMap{ash.dg[w], ash.dv[w], ash.dp[w]}, x, px);
        apply(exc, x, px);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            sD[j] = x;
            qD[j] = px;
            apply(delete_map(gate(tdd[k]), sM[j], gate(tmd[k]), qM[j]), x, px);
        }
        float vmax = ash.mv[0];
        int kmax = ash.mk[0], pmax_ = ash.mp[0];
        for (int w = 1; w < WARPS; ++w) {
            if (ash.mv[w] > vmax) {
                vmax = ash.mv[w];
                kmax = ash.mk[w];
                pmax_ = ash.mp[w];
            }
        }
        if (vmax > best) {
            best = vmax;
            b_pay = pmax_;
            b_row = i + 1;
            b_node = kmax + 1;
        }
    }

    // null2: sum matocc, sum insocc and matocc . e_a for the 21 residues
    float part[23];
#pragma unroll
    for (int q = 0; q < 23; ++q) part[q] = 0.0f;
    for (int j = 0; j < CHUNK; ++j) {
        const int k = base + j;
        const float m = matocc[k];
        part[21] += m;
        part[22] += insocc[k];
        if (k < row.M) {
#pragma unroll
            for (int q = 0; q < 21; ++q)
                part[q] += m * __ldg(a.e_odds + q * row.plane + row.base + k);
        }
    }
#pragma unroll
    for (int q = 0; q < 23; ++q) {
        const float w = warp_sum(part[q]);
        if (lane == 0) ash.red[warp][q] = w;
    }
    __syncthreads();
    if (tid < 21) {
        float dot = 0.0f, mat = 0.0f, ins = 0.0f;
        for (int w = 0; w < WARPS; ++w) {
            dot += ash.red[w][tid];
            mat += ash.red[w][21];
            ins += ash.red[w][22];
        }
        out[static_cast<size_t>(r) * 22 + 1 + tid] = null2_ratio(dot, mat, ins, xocc);
    }
    if (tid == 0) {
        out[static_cast<size_t>(r) * 22] = static_cast<float>(logf(eC * emove + 1e-38f) + elog);
        int32_t* c = coords + static_cast<size_t>(r) * 4;
        c[0] = b_pay / PAY;
        c[1] = b_row;
        c[2] = b_pay % PAY;
        c[3] = b_node;
    }
}

// A load of data that the kernel does not write (RO: the read-only path,
// __ldg), or of data that this warp wrote earlier in the same launch
// (kernel K's parked rows: a plain load, which sees the warp's own stores
// after a __syncwarp).
template <bool RO, typename T>
__device__ __forceinline__ T fetch(const T* p) {
    if constexpr (RO) {
        return __ldg(p);
    } else {
        return *p;
    }
}

// A lane's C bfloat16 values of a parked row, node l*C + j at value j:
// kernels F and K store a lane's nodes contiguously, so a lane loads its
// own 2C bytes, in 16-, 8- or 4-byte vectors where C allows.
template <int C>
struct Bf16Lane {
    uint32_t w[(C + 1) / 2];  // value 2m in the low half of word m

    template <bool RO = true>
    __device__ __forceinline__ void load(const __nv_bfloat16* src) {
        if constexpr (C % 2 == 1) {
            const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
            for (int m = 0; m < (C + 1) / 2; ++m) {
                const uint32_t lo = fetch<RO>(h + 2 * m);
                const uint32_t hi = 2 * m + 1 < C ? fetch<RO>(h + 2 * m + 1) : 0u;
                w[m] = lo | (hi << 16);
            }
        } else if constexpr (C % 8 == 0) {
#pragma unroll
            for (int q = 0; q < C / 8; ++q) {
                const uint4 u = fetch<RO>(reinterpret_cast<const uint4*>(src) + q);
                w[4 * q] = u.x;
                w[4 * q + 1] = u.y;
                w[4 * q + 2] = u.z;
                w[4 * q + 3] = u.w;
            }
        } else if constexpr (C % 4 == 0) {
#pragma unroll
            for (int q = 0; q < C / 4; ++q) {
                const uint2 u = fetch<RO>(reinterpret_cast<const uint2*>(src) + q);
                w[2 * q] = u.x;
                w[2 * q + 1] = u.y;
            }
        } else {
#pragma unroll
            for (int q = 0; q < C / 2; ++q)
                w[q] = fetch<RO>(reinterpret_cast<const uint32_t*>(src) + q);
        }
    }

    __device__ __forceinline__ float operator[](int j) const {
        const uint32_t u = w[j >> 1];
        return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
    }
};

// The OA gates of a lane's C nodes as bits (bit j: node l*C + j): t[slot]
// where transition `slot` is nonzero, `node` where the node mask nm is.
struct GateBits {
    uint32_t t[T_BM];
    uint32_t node;
    __device__ __forceinline__ float operator()(int slot, int j) const {
        return (t[slot] >> j) & 1u ? 0.0f : NEG;
    }
    __device__ __forceinline__ float node_neg(int j) const {
        return (node >> j) & 1u ? 0.0f : NEG;
    }
};

// `nm` is the lane's node-mask row of a lane-interleaved table.
template <int C, typename Trans>
__device__ __forceinline__ GateBits gate_bits(const Trans& tr, const float* nm) {
    GateBits g;
#pragma unroll
    for (int slot = 0; slot < T_BM; ++slot) {
        g.t[slot] = 0u;
#pragma unroll
        for (int j = 0; j < C; ++j) g.t[slot] |= (tr(slot, j) > 0.0f ? 1u : 0u) << j;
    }
    g.node = 0u;
#pragma unroll
    for (int j = 0; j < C; ++j) g.node |= (nm[j * 32] > 0.0f ? 1u : 0u) << j;
    return g;
}

// Store v[0..C) as bfloat16 at dst (2 * C bytes, aligned to their size's
// largest power of two up to 16): 16-byte stores where C is a multiple of
// 8, else 8-, 4- or 2-byte ones.
template <int C>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const float (&v)[C]) {
    if constexpr (C % 2 == 1) {
#pragma unroll
        for (int j = 0; j < C; ++j) dst[j] = __float2bfloat16_rn(v[j]);
    } else {
        uint32_t w[C / 2];
#pragma unroll
        for (int j = 0; j < C / 2; ++j) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
            w[j] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        if constexpr (C % 8 == 0) {
#pragma unroll
            for (int j = 0; j < C / 8; ++j)
                reinterpret_cast<uint4*>(dst)[j] = make_uint4(w[4 * j], w[4 * j + 1],
                                                              w[4 * j + 2], w[4 * j + 3]);
        } else if constexpr (C % 4 == 0) {
#pragma unroll
            for (int j = 0; j < C / 4; ++j)
                reinterpret_cast<uint2*>(dst)[j] = make_uint2(w[2 * j], w[2 * j + 1]);
        } else {
#pragma unroll
            for (int j = 0; j < C / 2; ++j) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
        }
    }
}

// park_backward for one warp that holds the row, C nodes a lane (kernels F
// and K): the Backward of the L residues of `xs` (length model loop/move)
// from the last one down to `lo`, parking residues lo..hi into `pk` at
// index o - pk.origin; `esm` the lane's emission-odds rows of a
// lane-interleaved table, `tr` its transitions, `nu` nm and U_{k+1},
// `right` chain_scan_right's slopes.  Each parked residue row is written
// as contiguous bytes, its first `fill` 16-byte chunks (at least 4 C), the
// nodes from 32 C on as zeros.  At C <= 8 each lane stores its C values as
// bfloat16 vectors (16 bytes at C = 8, 8 at C = 4, the lanes side by
// side); above, the lanes put their values in `buf`, two rows of 32 C
// bfloat16 values of the warp's own in shared memory, and the warp stores
// them 16 bytes a lane (__syncwarp, no barrier): with each lane's own
// 16-byte stores, 2 C bytes apart, kernel F took 3x as long at C = 32 on
// an H100 (tools/torch_domain_kernels.py).  Lane o mod 32 keeps residue
// o's bN, bJ, bC and log scale; every 32 residues, and at `lo`, the warp
// stores their logs as 32 consecutive floats of each of the four rows.
template <int C, typename Trans, typename Nodes>
__device__ __forceinline__ void warp_park_backward(const int8_t* xs, int L, float loop, float move,
                                                   const float* esm, const Trans& tr,
                                                   const Nodes& nu, const ChainScan& right,
                                                   const ParkedOut& pk, int lo, int hi, int fill,
                                                   __nv_bfloat16* buf) {
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    float bM[C], bI[C], e[C];
    warp_backward_init<C>(bM, bI, tr, nu, move);
    float bN = 0.0f, bJ = 0.0f, bC = move;
    double ls = 0.0;
    // residue o's bN, bJ, bC and log scale at lane o mod 32
    float kept[3] = {0.0f, 0.0f, 0.0f};
    double kept_ls = 0.0;
    ResidueStreamRev x(xs, L);
    {
        const int x0 = L > 0 ? x.next() : 0;  // residue L-1, the first step's
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
    }
    for (int o = L - 1; o >= lo; --o) {
        if (o < L - 1) {
            // residue o's emissions, for the step to o - 1
            const int xn = o > 0 ? x.next() : 0;
            float en[C];
#pragma unroll
            for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
            warp_backward_step<C>(bM, bI, bN, bJ, bC, ls, e, tr, nu, right, loop, move);
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
        }
        if (o <= hi) {
            const size_t at = static_cast<size_t>(o - pk.origin) * pk.width;
            uint4* m4 = reinterpret_cast<uint4*>(pk.pM + at);
            uint4* i4 = reinterpret_cast<uint4*>(pk.pI + at);
            if constexpr (C <= 8) {
                store_bf16<C>(pk.pM + at + lane * C, bM);
                store_bf16<C>(pk.pI + at + lane * C, bI);
                for (int q = 4 * C + lane; q < fill; q += 32) {
                    m4[q] = zero;
                    i4[q] = zero;
                }
            } else {
                store_bf16<C>(buf + lane * C, bM);
                store_bf16<C>(buf + W + lane * C, bI);
                __syncwarp();
                const uint4* b4 = reinterpret_cast<const uint4*>(buf);
                for (int q = lane; q < fill; q += 32) {
                    m4[q] = q < 4 * C ? b4[q] : zero;
                    i4[q] = q < 4 * C ? b4[4 * C + q] : zero;
                }
                __syncwarp();
            }
        }
        const int k = o & 31;
        if (lane == k) {
            kept[0] = bN;
            kept[1] = bJ;
            kept[2] = bC;
            kept_ls = ls;
        }
        if (k == 0 || o == lo) {  // residues o .. min(o - k + 31, hi), one a lane
            const int mine = o - k + lane;
            if (lane >= k && mine <= hi) {
                const int at = mine - pk.origin;
                const bool init = mine == L - 1;
                pk.blog[at] = static_cast<float>(kept_ls);
                pk.bNl[at] = init ? NEG : static_cast<float>(logf(kept[0] + TINY) + kept_ls);
                pk.bJl[at] = init ? NEG : static_cast<float>(logf(kept[1] + TINY) + kept_ls);
                pk.bCl[at] = init ? logf(move) : static_cast<float>(logf(kept[2] + TINY) + kept_ls);
            }
        }
    }
}

// The parked rows of one envelope row as a warp reads them: residue o's
// planes at pM + (o - origin) * width and pI + (o - origin) * width
// (bfloat16, node order), its logs at blog[o - origin], bNl, bJl, bCl
// likewise.  Kernel F parks whole sequences (origin 0), kernel K the
// envelope's residues (origin iv - 1).
struct WarpParked {
    const __nv_bfloat16 *pM, *pI;
    const float *blog, *bNl, *bJl, *bCl;
    size_t width;
    int origin;
};

// The envelope's own Forward over residues iv..jv (1-based) of `xs` by one
// warp, C nodes a lane (`esm`: the lane's emission-odds rows of a
// lane-interleaved table, `tr` its transitions, `chain` their delete-chain
// slopes); lane 0 writes envsc to *out.
template <int C, typename Trans>
__device__ __forceinline__ void warp_envelope_forward(const int8_t* xs, int iv, int jv,
                                                      const float* esm, const Trans& tr,
                                                      const ChainScan& chain, float* out) {
    constexpr int W = 32 * C;
    const float Ld = fmaxf(static_cast<float>(jv - iv) + 1.0f, 1.0f);
    const float eloop = Ld / (Ld + 3.0f);
    const float emove = 3.0f / (Ld + 3.0f);
    float eM[C], eI[C], eD[C], e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) eM[j] = eI[j] = eD[j] = 0.0f;
    float eN = 1.0f, eB = emove, eJ = 0.0f, eC = 0.0f;
    double elog = 0.0;  // in double, as warp_forward_traj's log scale
    const int n = jv - iv + 1;
    ResidueStream x(xs + (iv - 1), n);
    {
        const int x0 = n > 0 ? x.next() : 0;
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
    }
    for (int i = 0; i < n; ++i) {
        const int xn = i + 1 < n ? x.next() : 0;
        float en[C];
#pragma unroll
        for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
        elog += logf(warp_forward_step<C>(eM, eI, eD, eN, eB, eJ, eC, e, tr, chain, eloop, emove));
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = en[j];
    }
    if ((threadIdx.x & 31) == 0) *out = static_cast<float>(logf(eC * emove + 1e-38f) + elog);
}

// align_forward for one warp that holds the row, C nodes a lane, all its
// state in registers: residues i = 1 .. jv of `xs` (L residues, length
// model loop/move) with envelope [iv, jv] and Forward score `total`, over
// the parked rows `pk` (kernel F's, read-only: RO; or, RO false, the ones
// this warp parked earlier in the launch, kernel K's); `esm`, `tr`,
// `chain` as warp_envelope_forward's, `g` the OA gates.  Writes out[1..21]
// and coords[0..3]; the envelope's own Forward (out[0]) is
// warp_envelope_forward's.  No barrier.
template <int C, bool RO = true, typename Trans>
__device__ __forceinline__ void warp_align_forward(const int8_t* xs, int L, float loop, float move,
                                                   int iv, int jv, float total,
                                                   const WarpParked& pk, const float* esm,
                                                   const Trans& tr, const ChainScan& chain,
                                                   const GateBits& g, float* out,
                                                   int32_t* coords) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    const int base = lane * C;
    const float log_loop = logf(loop);
    float Mv[C], Iv[C], Dv[C];      // full-sequence Forward
    float sM[C], sI[C], sD[C];      // optimal accuracy
    int qM[C], qI[C], qD[C];        // their start payloads
    float matocc[C], insocc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
        Mv[j] = Iv[j] = Dv[j] = matocc[j] = insocc[j] = 0.0f;
        sM[j] = sI[j] = sD[j] = NEG;
        qM[j] = qI[j] = qD[j] = -1;
    }
    float N = 1.0f, B = move, J = 0.0f, Cs = 0.0f;
    double lsf = 0.0;  // in double, as warp_forward_traj's log scale
    float xpart = 0.0f, best = NEG;
    int b_pay = 0, b_row = 0, b_node = 0;
    // residue i's N, J, C and log scale before its step, at lane i mod 32
    float kept[3] = {0.0f, 0.0f, 0.0f};
    double kept_ls = 0.0;
    ResidueStream x(xs, L);
    float e[C];
    {
        const int x0 = jv > 0 ? x.next() : 0;
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
    }
    for (int i = 0; i < jv; ++i) {
        // the next residue's emissions, one step ahead
        const int xn = i + 1 < jv ? x.next() : 0;
        float en[C];
#pragma unroll
        for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
        if (i + 1 < iv) {
            lsf += logf(warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move));
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
            continue;
        }
        // residue i's parked rows, in flight while the Forward step runs
        const int at = i - pk.origin;
        Bf16Lane<C> rowM, rowI;
        rowM.template load<RO>(pk.pM + static_cast<size_t>(at) * pk.width + base);
        rowI.template load<RO>(pk.pI + static_cast<size_t>(at) * pk.width + base);
        const float blog = fetch<RO>(pk.blog + at);
        const int k = i & 31;
        if (lane == k) {
            kept[0] = N;
            kept[1] = J;
            kept[2] = Cs;
            kept_ls = lsf;
        }
        // OA values this lane's last node hands to the next lane (old row)
        float in_fm = __shfl_up_sync(FULL, sM[C - 1] + g(T_MM, C - 1), 1);
        float in_fi = __shfl_up_sync(FULL, sI[C - 1] + g(T_IM, C - 1), 1);
        float in_fd = __shfl_up_sync(FULL, sD[C - 1] + g(T_DM, C - 1), 1);
        int in_pm = __shfl_up_sync(FULL, qM[C - 1], 1);
        int in_pi = __shfl_up_sync(FULL, qI[C - 1], 1);
        int in_pd = __shfl_up_sync(FULL, qD[C - 1], 1);
        if (lane == 0) {
            in_fm = in_fi = in_fd = NEG;
            in_pm = in_pi = in_pd = -1;
        }
        lsf += logf(warp_forward_step<C>(Mv, Iv, Dv, N, B, J, Cs, e, tr, chain, loop, move));
        const float pscale = expf(static_cast<float>(lsf + blog - total));

        // optimal accuracy: match and insert cells, nodes high to low so
        // that node j-1 still holds the old row
#pragma unroll
        for (int j = C - 1; j >= 0; --j) {
            const float ppM = Mv[j] * rowM[j] * pscale;
            const float ppI = Iv[j] * rowI[j] * pscale;
            matocc[j] += ppM;
            insocc[j] += ppI;
            const int q = j > 0 ? j - 1 : 0;  // node j-1 of this lane
            const float fromM = j > 0 ? sM[q] + g(T_MM, q) : in_fm;
            const float fromI = j > 0 ? sI[q] + g(T_IM, q) : in_fi;
            const float fromD = j > 0 ? sD[q] + g(T_DM, q) : in_fd;
            const int payM = j > 0 ? qM[q] : in_pm;
            const int payI = j > 0 ? qI[q] : in_pi;
            const int payD = j > 0 ? qD[q] : in_pd;
            oa_cells(sM[j], sI[j], qM[j], qI[j], fromM, fromI, fromD, payM, payI, payD,
                     g(T_MI, j), g(T_II, j), g.node_neg(j), ppM, ppI,
                     (i + 1) * PAY + (base + j + 1));
        }
        // delete chain (max-plus scan) and the row max with its lowest node
        MaxMap f{0.0f, -INFINITY, -1};
        float rmax = -INFINITY;
        int rk = 0, rp = -1;
#pragma unroll
        for (int j = 0; j < C; ++j) {
            f = compose(f, delete_map(g(T_DD, j), sM[j], g(T_MD, j), qM[j]));
            if (sM[j] > rmax) {
                rmax = sM[j];
                rk = base + j;
                rp = qM[j];
            }
        }
        const MaxMap exc = warp_exclusive(warp_delete_scan(f));
        float xd = NEG;
        int px = -1;
        apply(exc, xd, px);
#pragma unroll
        for (int j = 0; j < C; ++j) {
            sD[j] = xd;
            qD[j] = px;
            apply(delete_map(g(T_DD, j), sM[j], g(T_MD, j), qM[j]), xd, px);
        }
        warp_row_max(rmax, rk, rp);
        if (rmax > best) {
            best = rmax;
            b_pay = rp;
            b_row = i + 1;
            b_node = rk + 1;
        }
        // special-state posteriors of residues i - k .. i, one a lane
        if (k == 31 || i == jv - 1) {
            const int mine = i - k + lane;
            if (lane <= k && mine >= iv - 1) {
                const int m = mine - pk.origin;
                const double lsp = kept_ls + log_loop;
                const float ppN = expf(static_cast<float>(
                    logf(kept[0] + TINY) + lsp + fetch<RO>(pk.bNl + m) - total));
                const float ppJ = expf(static_cast<float>(
                    logf(kept[1] + TINY) + lsp + fetch<RO>(pk.bJl + m) - total));
                const float ppC = expf(static_cast<float>(
                    logf(kept[2] + TINY) + lsp + fetch<RO>(pk.bCl + m) - total));
                xpart += fminf(fmaxf(ppN + ppJ + ppC, 0.0f), 1.0f);
            }
        }
#pragma unroll
        for (int j = 0; j < C; ++j) e[j] = en[j];
    }

    // null2: sum matocc, sum insocc and matocc . e_a for the 21 residues
    float part[23];
#pragma unroll
    for (int q = 0; q < 23; ++q) part[q] = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
        part[21] += matocc[j];
        part[22] += insocc[j];
#pragma unroll
        for (int q = 0; q < 21; ++q) part[q] += matocc[j] * esm[q * W + j * 32];
    }
    const float xocc = warp_sum(xpart);
    const float mat = warp_sum(part[21]);
    const float ins = warp_sum(part[22]);
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < 21; ++q) {
        const float sum = warp_sum(part[q]);
        if (lane == q) dot = sum;
    }
    if (lane < 21) out[1 + lane] = null2_ratio(dot, mat, ins, xocc);
    if (lane == 0) {
        coords[0] = b_pay / PAY;
        coords[1] = b_row;
        coords[2] = b_pay % PAY;
        coords[3] = b_node;
    }
}

}  // namespace gecco

// The alignment Forward's thread shapes: its registers per node are ~3x the
// Forward's, so wider classes take more threads with fewer nodes each.
#define GECCO_DISPATCH_ALIGN(width, LAUNCH)                     \
    switch (width) {                                            \
        case 128: err = LAUNCH(32, 4); break;                   \
        case 256: err = LAUNCH(64, 4); break;                   \
        case 512: err = LAUNCH(128, 4); break;                  \
        case 1024: err = LAUNCH(256, 4); break;                 \
        case 2048: err = LAUNCH(512, 4); break;                 \
        case 4096: err = LAUNCH(512, 8); break;                 \
        default: err = cudaErrorInvalidValue;                   \
    }
