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
// An empty sequence scores NEG.
//
// Bound on the H100: operations.  Three float operations per DP cell
// (emission add, entry max, running max of E) and one shared-memory
// read; ~450 Gcells per 3,000-protein genome against 2,766 Pfam-sized
// profiles.  The only device-memory traffic is the residues (L1-resident)
// and one score per pair.
//
// Design: unlike SSV (kernel A, ssv.cu), the J loop couples every node
// of a row: E(i) is a maximum over all nodes and B(i) enters every node
// of row i+1, so the diagonals cannot run apart.  One warp scores one
// sequence against one profile, lane l owning the contiguous nodes
// [l*C, (l+1)*C) of the width class (C = width / 32).  Per residue one
// __shfl_up_sync brings lane l-1's last old M for the node shift, each
// lane rewrites its nodes from the top down in place, a lane max and a
// warp max (__shfl_xor_sync) give E, and every lane updates N, J, C and
// B redundantly: no barrier inside the residue loop.  A block holds one
// profile's 21 x width log-odds table in shared memory, lane-interleaved
// (node l*C + j at j*32 + l) so that a warp's reads fall in 32 banks,
// and its warps take a tile of sequences in turn.  M stays in registers
// up to 64 nodes a lane (the 2,048-node class).  At 4,096 nodes the 128
// nodes a lane would spill, so M goes to shared memory (lane-interleaved,
// one slice per warp) and the table, too wide for shared memory, is read
// through the read-only cache.  Nodes at or past the model length get
// NEG emissions: the shift runs towards higher nodes, so they never feed
// a real node, and node 0's predecessor is NEG.  The result is exact at
// any width; the TPU kernel's lane-0 mask has no counterpart here.
#include "common.cuh"

using namespace gecco;

namespace {

constexpr int MSV_WARPS = 8;
constexpr int MSV_THREADS = 32 * MSV_WARPS;
constexpr int MSV_SEQ_TILE = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// C nodes a lane, width 32 * C; C > 64 keeps M in shared memory and reads
// the table through the read-only cache.
template <int C>
__global__ void __launch_bounds__(MSV_THREADS)
msv_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
           const int32_t* __restrict__ lens, const float* __restrict__ loops,
           const float* __restrict__ moves, int n_seqs,
           const float* __restrict__ e_log, const float* __restrict__ tbm,
           const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
           int P, int Mp, float* __restrict__ out) {
    constexpr int W = 32 * C;
    constexpr bool WIDE = C > 64;
    // the table [21][W], or with WIDE each warp's M [W]; both lane-interleaved
    extern __shared__ float smem[];

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int s0 = blockIdx.x * MSV_SEQ_TILE;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;

    if constexpr (!WIDE) {
        for (int idx = threadIdx.x; idx < K_ALPHA * W; idx += MSV_THREADS) {
            const int a = idx / W;
            const int k = idx - a * W;
            const int owner = k / C;
            smem[a * W + (k - owner * C) * 32 + owner] = k < M ? profile[a * plane + k] : NEG;
        }
        __syncthreads();
    }

    float Mr[WIDE ? 1 : C];
    float* Ms = smem + warp * W;  // WIDE only
    const float tb = tbm[p];
    const int n_tile = min(MSV_SEQ_TILE, n_seqs - s0);
    for (int t = warp; t < n_tile; t += MSV_WARPS) {
        const int s = s0 + t;
        const int L = lens[s];
        const int8_t* x = xs + offsets[s];
        const float loop = loops[s];
        const float move = moves[s];
#pragma unroll
        for (int j = 0; j < C; ++j) {
            if constexpr (WIDE) Ms[j * 32 + lane] = NEG;
            else Mr[j] = NEG;
        }
        float N = 0.0f, B = move, J = NEG, Cst = NEG;
        int xi = L > 0 ? x[0] : 0;
        for (int i = 0; i < L; ++i) {
            const int xn = i + 1 < L ? x[i + 1] : 0;
            const float bt = __fadd_rn(B, tb);
            float last;
            if constexpr (WIDE) last = Ms[(C - 1) * 32 + lane];
            else last = Mr[C - 1];
            float prev = __shfl_up_sync(FULL_MASK, last, 1);
            if (lane == 0) prev = NEG;
            const float* row;
            if constexpr (WIDE) row = profile + static_cast<size_t>(xi) * plane + lane * C;
            else row = smem + xi * W + lane;
            // two running maxima of E (max is exact in any order)
            float E0 = NEG, E1 = NEG;
#pragma unroll
            for (int j = C - 1; j >= 0; --j) {
                float before, e;
                if constexpr (WIDE) {
                    before = j > 0 ? Ms[(j - 1) * 32 + lane] : prev;
                    e = lane * C + j < M ? __ldg(row + j) : NEG;
                } else {
                    before = j > 0 ? Mr[j - 1] : prev;
                    e = row[j * 32];
                }
                const float mn = __fadd_rn(e, fmaxf(before, bt));
                if constexpr (WIDE) Ms[j * 32 + lane] = mn;
                else Mr[j] = mn;
                if (j == C - 1) E0 = mn;
                else if (j == C - 2) E1 = mn;
                else if (j & 1) E0 = fmaxf(E0, mn);
                else E1 = fmaxf(E1, mn);
            }
            const float E = warp_max(C > 1 ? fmaxf(E0, E1) : E0);
            const float elm = __fadd_rn(E, LOG_HALF);
            J = fmaxf(__fadd_rn(J, loop), elm);
            Cst = fmaxf(__fadd_rn(Cst, loop), elm);
            N = __fadd_rn(N, loop);
            B = __fadd_rn(fmaxf(N, J), move);
            xi = xn;
        }
        if (lane == 0) out[static_cast<size_t>(s) * P + p] = L > 0 ? __fadd_rn(Cst, move) : NEG;
    }
}

template <int C>
cudaError_t launch(int n_seqs, int n_prof, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* e_log,
                   const void* tbm, const int32_t* prof_idx, const void* model_len, int P,
                   int Mp, void* out) {
    constexpr int W = 32 * C;
    const size_t smem = sizeof(float) * (C > 64 ? MSV_WARPS * W : K_ALPHA * W);
    cudaError_t err = allow_smem(msv_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (n_seqs + MSV_SEQ_TILE - 1) / MSV_SEQ_TILE;
    for (int y0 = 0; y0 < n_prof; y0 += 65535) {
        dim3 grid(tiles, min(65535, n_prof - y0));
        msv_kernel<C><<<grid, MSV_THREADS, smem, st>>>(
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
extern "C" int gecco_msv_filter(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, int n_seqs,
                                const void* e_log, const void* tbm, const void* prof_idx,
                                int n_prof, const void* model_len, int P, int Mp, int width,
                                void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* idx = static_cast<const int32_t*>(prof_idx);
#define GECCO_MSV_LAUNCH(C) \
    launch<C>(n_seqs, n_prof, st, xs, offsets, lens, loops, moves, e_log, tbm, idx, model_len, \
              P, Mp, out)
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
