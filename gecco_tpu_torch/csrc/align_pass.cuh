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
    Plane *pM, *pI;                   // [rows][WIDTH] bfloat16
    Scalar *blog, *bNl, *bJl, *bCl;   // [rows]
    int origin;
};
using ParkedOut = ParkedRows<__nv_bfloat16, float>;
using ParkedIn = ParkedRows<const __nv_bfloat16, const float>;

// Backward from the row's last residue down to `lo`, parking residues
// lo..hi (0-based).  Every thread of the block calls it; `U` [WIDTH + 1] is
// its delete-chain basis (backward_step.cuh).
template <int THREADS, int CHUNK>
__device__ __forceinline__ void park_backward(const RowArgs& a, const Row& row, const float* tsm,
                                              const float* nm, float* U,
                                              BackwardScratch<THREADS>& sh,
                                              const ParkedOut& parked, int lo, int hi) {
    constexpr int WIDTH = THREADS * CHUNK;
    const int base = threadIdx.x * CHUNK;
    Backward<THREADS, CHUNK> bw{tsm, nm, U, sh};
    bw.init(row.move);
    for (int o = row.L - 1; o >= lo; --o) {
        const bool init = o == row.L - 1;
        if (!init) bw.step(emission_row(a.e_odds, row, o + 1), row.M, row.loop, row.move);
        if (o > hi) continue;
        const int at = o - parked.origin;
        __nv_bfloat16* m = parked.pM + static_cast<size_t>(at) * WIDTH + base;
        __nv_bfloat16* ins = parked.pI + static_cast<size_t>(at) * WIDTH + base;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            m[j] = __float2bfloat16_rn(bw.bM[j]);
            ins[j] = __float2bfloat16_rn(bw.bI[j]);
        }
        if (threadIdx.x == 0) {
            parked.blog[at] = bw.ls;
            parked.bNl[at] = init ? NEG : logf(bw.bN + TINY) + bw.ls;
            parked.bJl[at] = init ? NEG : logf(bw.bJ + TINY) + bw.ls;
            parked.bCl[at] = init ? logf(row.move) : logf(bw.bC + TINY) + bw.ls;
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
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f, lsf = 0.0f;
    float eN = 1.0f, eB = emove, eJ = 0.0f, eC = 0.0f, elog = 0.0f;
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
        const float ppN = expf(logf(N + TINY) + lsf + log_loop + parked.bNl[at] - total);
        const float ppJ = expf(logf(J + TINY) + lsf + log_loop + parked.bJl[at] - total);
        const float ppC = expf(logf(C + TINY) + lsf + log_loop + parked.bCl[at] - total);
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
        const float pscale = expf(lsf + parked.blog[at] - total);
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
        const __nv_bfloat16* rowM = parked.pM + static_cast<size_t>(at) * WIDTH + base;
        const __nv_bfloat16* rowI = parked.pI + static_cast<size_t>(at) * WIDTH + base;
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
            const float pmax = fmaxf(fromM, fmaxf(fromI, fromD));
            const bool useM = fromM >= pmax;
            const bool useI = !useM && fromI >= pmax;
            const float node_neg = nm[k] > 0.0f ? 0.0f : NEG;
            const float fromMi = sM[j] + gate(tmi[k]);
            const float fromIi = sI[j] + gate(tii[k]);
            const bool useMi = fromMi >= fromIi;
            const int payIn = useMi ? qM[j] : qI[j];
            sI[j] = (node_neg + ppI) + fmaxf(fromMi, fromIi);
            qI[j] = payIn;
            sM[j] = (node_neg + ppM) + fmaxf(pmax, 0.0f);
            qM[j] = pmax <= 0.0f ? (i + 1) * PAY + (k + 1) : (useM ? payM : (useI ? payI : payD));
        }
        // delete chain (max-plus scan) and the row max with its lowest node
        MaxMap f{0.0f, -INFINITY, -1};
        float rmax = -INFINITY;
        int rk = 0, rp = -1;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            f = compose(f, MaxMap{gate(tdd[k]), sM[j] + gate(tmd[k]), qM[j]});
            if (sM[j] > rmax) {
                rmax = sM[j];
                rk = k;
                rp = qM[j];
            }
        }
        MaxMap inc = f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            MaxMap left;
            left.g = __shfl_up_sync(0xffffffffu, inc.g, o);
            left.v = __shfl_up_sync(0xffffffffu, inc.v, o);
            left.p = __shfl_up_sync(0xffffffffu, inc.p, o);
            if (lane >= o) inc = compose(left, inc);
        }
        MaxMap exc;
        exc.g = __shfl_up_sync(0xffffffffu, inc.g, 1);
        exc.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
        exc.p = __shfl_up_sync(0xffffffffu, inc.p, 1);
        if (lane == 0) exc = MaxMap{0.0f, -INFINITY, -1};
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
            apply(MaxMap{gate(tdd[k]), sM[j] + gate(tmd[k]), qM[j]}, x, px);
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
        const float inv_tot = 1.0f / fmaxf(mat + ins + xocc, 1e-30f);
        // log(max(n2, 1e-300)) in float32, where 1e-300 rounds to 0
        out[static_cast<size_t>(r) * 22 + 1 + tid] = logf(fmaxf((dot + ins + xocc) * inv_tot, 0.0f));
    }
    if (tid == 0) {
        out[static_cast<size_t>(r) * 22] = logf(eC * emove + 1e-38f) + elog;
        int32_t* c = coords + static_cast<size_t>(r) * 4;
        c[0] = b_pay / PAY;
        c[1] = b_row;
        c[2] = b_pay % PAY;
        c[3] = b_node;
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
