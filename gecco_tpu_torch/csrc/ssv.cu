// Kernel A: SSV filter scores of every (sequence, profile) pair.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_ssv_quad (the F1 filter of
// SearchPipeline.search).  For each pair it returns, in nats,
//
//   max_{i,k} A_k(i) + L*loop + log(1/2) + move,
//   A_k(i) = (e_k(x_i) - loop) + max(A_{k-1}(i-1), tbm + move),
//
// the host oracle gecco_tpu.hmm.engine.ssv_score.
//
// Bound on the H100: compute.  About 5 float operations and two
// shared-memory reads per DP cell, ~450 Gcells per 3,000-protein genome
// against 2,766 Pfam-sized profiles; the only device-memory traffic is
// the residues (L1-resident) and one score per pair.
//
// Design: the SSV recurrence only runs along diagonals (cell (i, k)
// depends on (i-1, k-1) alone), so each thread walks whole diagonals
// with no communication: no shuffles, no barriers inside the residue
// loop, and exact at every model width (the TPU kernel's lane rolls
// needed three dead pad lanes; here nodes past M are never touched).
// One block holds one profile's 21 x M log-odds table in shared memory
// and scores a tile of sequences against it; a thread that finishes its
// diagonals of one sequence moves on to the next, so the only barrier
// is at the end of the tile.  Tables wider than the shared-memory cap
// are read through the read-only cache instead.
#include "common.cuh"

using namespace gecco;

namespace {

constexpr int SSV_THREADS = 256;
constexpr int SSV_SEQ_TILE = 16;
constexpr size_t SSV_SMEM_CAP = 200 * 1024;

template <bool SMEM>
__global__ void __launch_bounds__(SSV_THREADS)
ssv_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
           const int32_t* __restrict__ lens, const float* __restrict__ loops,
           const float* __restrict__ moves, int n_seqs,
           const float* __restrict__ e_log, const float* __restrict__ tbm,
           const int32_t* __restrict__ prof_idx, const int32_t* __restrict__ model_len,
           int P, int Mp, int width, float* __restrict__ out) {
    extern __shared__ float table_smem[];
    __shared__ unsigned best_bits[SSV_SEQ_TILE];

    const int p = prof_idx[blockIdx.y];
    const int M = model_len[p];
    const int s0 = blockIdx.x * SSV_SEQ_TILE;
    const int tid = threadIdx.x;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const float* profile = e_log + static_cast<size_t>(p) * Mp;

    if (SMEM) {
        for (int idx = tid; idx < K_ALPHA * M; idx += blockDim.x) {
            const int a = idx / M;
            const int k = idx - a * M;
            table_smem[a * width + k] = profile[a * plane + k];
        }
    }
    if (tid < SSV_SEQ_TILE) best_bits[tid] = ordered_bits(NEG);
    __syncthreads();

    const float tb = tbm[p];
    const int n_tile = min(SSV_SEQ_TILE, n_seqs - s0);
    for (int t = 0; t < n_tile; ++t) {
        const int s = s0 + t;
        const int L = lens[s];
        const int8_t* x = xs + offsets[s];
        const float loop = loops[s];
        const float cb0 = tb + moves[s];
        float best = NEG;
        // diagonal d holds the cells with i - k == d - (M - 1)
        const int n_diag = L + M - 1;
        for (int d = tid; d < n_diag; d += blockDim.x) {
            const int i = max(0, d - (M - 1));
            const int k = i - d + (M - 1);
            const int n = min(L - i, M - k);
            float A = NEG;
            for (int u = 0; u < n; ++u) {
                const int xi = x[i + u];
                const float e = SMEM ? table_smem[xi * width + k + u]
                                     : __ldg(profile + xi * plane + k + u);
                A = (e - loop) + fmaxf(A, cb0);
                best = fmaxf(best, A);
            }
        }
        best = warp_max(best);
        if ((tid & 31) == 0) atomicMax(&best_bits[t], ordered_bits(best));
    }
    __syncthreads();

    if (tid < n_tile) {
        const int s = s0 + tid;
        const int L = lens[s];
        float score = NEG;
        if (L > 0) {
            // ((L * loop) + log 1/2) + move, rounded like the JAX kernel
            float c = __fmul_rn(static_cast<float>(L), loops[s]);
            c = __fadd_rn(c, LOG_HALF);
            c = __fadd_rn(c, moves[s]);
            score = __fadd_rn(ordered_float(best_bits[tid]), c);
        }
        out[static_cast<size_t>(s) * P + p] = score;
    }
}

template <bool SMEM>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, int n_seqs,
                   const void* e_log, const void* tbm, const int32_t* prof_idx,
                   const void* model_len, int P, int Mp, int width, void* out) {
    ssv_kernel<SMEM><<<grid, SSV_THREADS, smem, st>>>(
        static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
        static_cast<const float*>(moves), n_seqs, static_cast<const float*>(e_log),
        static_cast<const float*>(tbm), prof_idx, static_cast<const int32_t*>(model_len), P, Mp,
        width, static_cast<float*>(out));
    return cudaGetLastError();
}

}  // namespace

// Scores the profiles prof_idx[0..n_prof) (all of model length <= width)
// against every sequence; writes out[s * P + p].  Returns a CUDA error code.
extern "C" int gecco_ssv_filter(const void* xs, const void* offsets, const void* lens,
                                const void* loops, const void* moves, int n_seqs,
                                const void* e_log, const void* tbm, const void* prof_idx,
                                int n_prof, const void* model_len, int P, int Mp, int width,
                                void* out, void* stream) {
    if (n_seqs <= 0 || n_prof <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = sizeof(float) * K_ALPHA * static_cast<size_t>(width);
    const bool use_smem = smem <= SSV_SMEM_CAP;
    if (use_smem) {
        cudaError_t err = allow_smem(ssv_kernel<true>, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles = (n_seqs + SSV_SEQ_TILE - 1) / SSV_SEQ_TILE;
    for (int y0 = 0; y0 < n_prof; y0 += 65535) {
        dim3 grid(tiles, min(65535, n_prof - y0));
        const int32_t* idx = static_cast<const int32_t*>(prof_idx) + y0;
        cudaError_t err = use_smem
            ? launch<true>(grid, smem, st, xs, offsets, lens, loops, moves, n_seqs, e_log, tbm,
                           idx, model_len, P, Mp, width, out)
            : launch<false>(grid, 0, st, xs, offsets, lens, loops, moves, n_seqs, e_log, tbm,
                            idx, model_len, P, Mp, width, out);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
