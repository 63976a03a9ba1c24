// Kernel C: Forward (sum-product, probability space) scores of listed pairs.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_score with viterbi=False (the
// F3 Forward rescore of SearchPipeline.search), and the pair kernels
// (kernels.py::_pallas_pair_fwd / _pallas_pair_fwd_ilp) that F3 fell back
// to for sequences longer than 4,096 residues.  The recurrence is
// stream.py:1117-1149 in probability space, rescaled every residue:
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
// Bound on the H100: latency of the per-residue dependency chain (a
// serial DP over residues, a scan and a sum over nodes inside each
// step); ~12 float operations and one emission read from device memory
// per DP cell.
//
// Design: one block per pair, CHUNK consecutive nodes per thread in
// registers, transitions staged once in shared memory, and the residue
// step of forward_step.cuh (shared with kernels D and G): the delete
// chain as an exact scan of affine maps, two barriers per residue.
// Emission rows are read by residue index straight from the bank tensor,
// so any sequence length is taken.
#include "forward_step.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ lens, const float* __restrict__ loops,
               const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
               const int32_t* __restrict__ pair_prof, const float* __restrict__ e_odds,
               const float* __restrict__ trans, const int32_t* __restrict__ model_len, int P,
               int Mp, const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
               float* __restrict__ out) {
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
    const int8_t* x = xs + offsets[s] + start;
    const float loop = loops[s];
    const float move = moves[s];

    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f, ls = 0.0f;
    float score = windowed ? -INFINITY : NEG;

    for (int i = 0; i < L; ++i) {
        const float* e = e_odds + static_cast<size_t>(x[i]) * plane + row;
        ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, M, loop, move, sh));
        if (i == L - 1) score = logf(C * move + 1e-38f) + ls;
    }
    if (threadIdx.x == 0) out[pair] = score;
}

template <int THREADS, int CHUNK>
cudaError_t launch(int n_pairs, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* pair_seq,
                   const void* pair_prof, const void* e_odds, const void* trans,
                   const void* model_len, int P, int Mp, const void* starts, const void* ends,
                   void* out) {
    const size_t smem = sizeof(float) * 8 * THREADS * CHUNK;
    cudaError_t err = allow_smem(forward_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    forward_kernel<THREADS, CHUNK><<<n_pairs, THREADS, smem, st>>>(
        static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
        static_cast<const float*>(moves), static_cast<const int32_t*>(pair_seq),
        static_cast<const int32_t*>(pair_prof), static_cast<const float*>(e_odds),
        static_cast<const float*>(trans), static_cast<const int32_t*>(model_len), P, Mp,
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        static_cast<float*>(out));
    return cudaGetLastError();
}

}  // namespace

// Scores n_pairs (pair_seq[r], pair_prof[r]) pairs whose profiles all have
// model length <= width (128, 256, ..., 4096); loops/moves are probabilities
// (exp of the length model).  starts/ends [n_pairs] int32 are the rows'
// residue windows (0 <= start <= end <= length), or both null for whole
// sequences.  Writes out[r]; returns a CUDA error code.
extern "C" int gecco_forward_pairs(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* pair_seq,
                                   const void* pair_prof, int n_pairs, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, const void* starts, const void* ends, void* out,
                                   void* stream) {
    if (n_pairs <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C)                                                                     \
    launch<T, C>(n_pairs, st, xs, offsets, lens, loops, moves, pair_seq, pair_prof, e_odds,   \
                 trans, model_len, P, Mp, starts, ends, out)
    cudaError_t err;
    GECCO_DISPATCH_WIDTH(width, GECCO_LAUNCH)
#undef GECCO_LAUNCH
    return static_cast<int>(err);
}
