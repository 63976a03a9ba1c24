// Kernel B: Viterbi (max-plus, log space) scores of listed pairs.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_fwd_ilp in its log-space
// Viterbi form (the F2 gate of SearchPipeline.search), and
// _pallas_pair_fwd where F2 took it for profiles of 2048 nodes or more.
// For each (sequence, profile) pair it runs the Plan7 M/I/D max-plus
// recurrence of kernels.py:1397-1427:
//
//   M_k = e_k(x_i) + max(max(M_{k-1} + tmm, I_{k-1} + tim, D_{k-1} + tdm)_{k-1},
//                         B + bm_k)
//   I_k = max(M_k + tmi_k, I_k + tii_k)                  (previous row)
//   D_j = S_{j-1} + max_{i<j} (M_i + log tmd_i - S_i),    S = prefix sum of log tdd
//   E = max_k M_k, J/C/N/B as HMMER's multihit length model,
//
// and returns C + move in nats.  Slots 5 and 6 of the transition tensor
// hold log tmd - S and S_{j-1} (gecco_tpu_torch.hmm.bank).
//
// With per-row windows (`starts`, `ends`, 0-based half-open; null for the
// whole sequence) it also replaces _pallas_pair_fwd's Viterbi over a
// residue window (`ranges`): the recurrence starts afresh at `start`, ends
// at `end`, under the WHOLE sequence's loop and move.  An empty window
// scores -inf, as the TPU kernel's probability-space log(0 + 1e-38) does
// where 1e-38, a subnormal, is flushed.
//
// Bound on the H100: latency of the per-residue dependency chain.  A
// pair is one serial dynamic program over its residues with a scan over
// the nodes inside each step; per DP cell the work is ~10 float
// operations and one emission read from device memory.
//
// Design: one block per pair, each thread owning a run of CHUNK
// consecutive nodes in registers, the transitions staged once in shared
// memory.  Each residue step costs two barriers: one to hand every
// chunk's last node to its right neighbour, one to combine the
// per-warp prefix maxima of the delete chain (computed exactly, a warp
// shuffle scan then a pass over the warp totals) and the E maximum.
// Profiles are addressed by index into the bank tensors; nothing is
// gathered.  Every width up to 4096 nodes and any sequence length.
#include "common.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
viterbi_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ lens, const float* __restrict__ loops,
               const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
               const int32_t* __restrict__ pair_prof, const float* __restrict__ e_log,
               const float* __restrict__ trans_log, const int32_t* __restrict__ model_len,
               int P, int Mp, const int32_t* __restrict__ starts,
               const int32_t* __restrict__ ends, float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    constexpr int WARPS = THREADS / 32;
    extern __shared__ float tsm[];  // [8][WIDTH] log transitions
    __shared__ float sh_stay[THREADS];
    __shared__ float sh_scan[WARPS];
    __shared__ float sh_emax[WARPS];

    const int pair = blockIdx.x;
    const int s = pair_seq[pair];
    const int p = pair_prof[pair];
    const int M = model_len[p];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t row = static_cast<size_t>(p) * Mp;

    for (int idx = tid; idx < 8 * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        tsm[idx] = k < M ? trans_log[slot * plane + row + k] : NEG;
    }
    __syncthreads();
    const float* tmm = tsm;
    const float* tim = tsm + WIDTH;
    const float* tdm = tsm + 2 * WIDTH;
    const float* tmi = tsm + 3 * WIDTH;
    const float* tii = tsm + 4 * WIDTH;
    const float* tmdS = tsm + 5 * WIDTH;
    const float* Sm1 = tsm + 6 * WIDTH;
    const float* bm = tsm + 7 * WIDTH;

    const bool windowed = starts != nullptr;
    const int start = windowed ? starts[pair] : 0;
    const int L = windowed ? ends[pair] - start : lens[s];
    const int8_t* x = xs + offsets[s] + start;
    const float loop = loops[s];
    const float move = moves[s];
    const int base = tid * CHUNK;

    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = NEG;
    float N = 0.0f, B = move, J = NEG, C = NEG;

    for (int i = 0; i < L; ++i) {
        const float* e = e_log + static_cast<size_t>(x[i]) * plane + row;
        {
            const int k = base + CHUNK - 1;
            sh_stay[tid] = fmaxf(fmaxf(Mv[CHUNK - 1] + tmm[k], Iv[CHUNK - 1] + tim[k]),
                                 Dv[CHUNK - 1] + tdm[k]);
        }
        __syncthreads();
        const float prev = tid > 0 ? sh_stay[tid - 1] : NEG;
        // descending, so node j-1 still holds the previous row
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            const int k = base + j;
            const int q = j > 0 ? j - 1 : 0;  // node k-1 of this chunk
            const float stay =
                j > 0 ? fmaxf(fmaxf(Mv[q] + tmm[base + q], Iv[q] + tim[base + q]),
                              Dv[q] + tdm[base + q])
                      : prev;
            if (k < M) {
                const float mn = __ldg(e + k) + fmaxf(stay, B + bm[k]);
                Iv[j] = fmaxf(Mv[j] + tmi[k], Iv[j] + tii[k]);
                Mv[j] = mn;
            } else {
                Mv[j] = NEG;
                Iv[j] = NEG;
            }
        }
        // delete chain: exclusive prefix max of M + (log tmd - S)
        float emax = NEG;
        float incl = NEG;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            emax = fmaxf(emax, Mv[j]);
            incl = fmaxf(incl, Mv[j] + tmdS[base + j]);
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl = fmaxf(incl, y);
        }
        float run = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) run = NEG;
        emax = warp_max(emax);
        if (lane == 31) sh_scan[warp] = incl;
        if (lane == 0) sh_emax[warp] = emax;
        __syncthreads();
        float E = NEG;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w < warp) run = fmaxf(run, sh_scan[w]);
            E = fmaxf(E, sh_emax[w]);
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            Dv[j] = k < M ? Sm1[k] + run : NEG;
            run = fmaxf(run, Mv[j] + tmdS[k]);
        }
        const float Elm = E + LOG_HALF;
        J = fmaxf(J + loop, Elm);
        C = fmaxf(C + loop, Elm);
        N = N + loop;
        B = fmaxf(N, J) + move;
    }
    if (tid == 0) out[pair] = windowed && L == 0 ? -INFINITY : C + move;
}

template <int THREADS, int CHUNK>
cudaError_t launch(int n_pairs, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* pair_seq,
                   const void* pair_prof, const void* e_log, const void* trans_log,
                   const void* model_len, int P, int Mp, const void* starts, const void* ends,
                   void* out) {
    const size_t smem = sizeof(float) * 8 * THREADS * CHUNK;
    cudaError_t err = allow_smem(viterbi_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    viterbi_kernel<THREADS, CHUNK><<<n_pairs, THREADS, smem, st>>>(
        static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
        static_cast<const float*>(moves), static_cast<const int32_t*>(pair_seq),
        static_cast<const int32_t*>(pair_prof), static_cast<const float*>(e_log),
        static_cast<const float*>(trans_log), static_cast<const int32_t*>(model_len), P, Mp,
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        static_cast<float*>(out));
    return cudaGetLastError();
}

}  // namespace

// Scores n_pairs (pair_seq[r], pair_prof[r]) pairs whose profiles all have
// model length <= width (128, 256, ..., 4096); starts/ends [n_pairs] int32
// are the rows' residue windows (0 <= start <= end <= length), or both null
// for whole sequences.  Writes out[r]; returns a CUDA error code.
extern "C" int gecco_viterbi_pairs(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* pair_seq,
                                   const void* pair_prof, int n_pairs, const void* e_log,
                                   const void* trans_log, const void* model_len, int P, int Mp,
                                   int width, const void* starts, const void* ends, void* out,
                                   void* stream) {
    if (n_pairs <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C)                                                                     \
    launch<T, C>(n_pairs, st, xs, offsets, lens, loops, moves, pair_seq, pair_prof, e_log,    \
                 trans_log, model_len, P, Mp, starts, ends, out)
    cudaError_t err;
    switch (width) {
        case 128: err = GECCO_LAUNCH(32, 4); break;
        case 256: err = GECCO_LAUNCH(64, 4); break;
        case 512: err = GECCO_LAUNCH(128, 4); break;
        case 1024: err = GECCO_LAUNCH(256, 4); break;
        case 2048: err = GECCO_LAUNCH(256, 8); break;
        case 4096: err = GECCO_LAUNCH(256, 16); break;
        default: err = cudaErrorInvalidValue;
    }
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
