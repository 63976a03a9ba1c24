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
// Bound on the H100: latency of the per-residue dependency chain (a
// serial DP over residues, a scan and a sum over nodes inside each
// step); ~12 float operations and one emission read from device memory
// per DP cell.
//
// Design: one block per pair, CHUNK consecutive nodes per thread in
// registers, transitions staged once in shared memory.  The delete chain
// is computed exactly as a scan of affine maps D -> a*D + b across the
// nodes (thread-local, then a warp shuffle scan, then a pass over the
// warp totals); the E sum rides in the same pass, because each thread's
// share of sum_k D_k is itself affine in the value entering its warp.
// Two barriers per residue.  Emission rows are read by residue index
// straight from the bank tensor, so any sequence length is taken.
#include "common.cuh"

using namespace gecco;

namespace {

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ lens, const float* __restrict__ loops,
               const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
               const int32_t* __restrict__ pair_prof, const float* __restrict__ e_odds,
               const float* __restrict__ trans, const int32_t* __restrict__ model_len, int P,
               int Mp, float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    constexpr int WARPS = THREADS / 32;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ float sh_stay[THREADS];
    __shared__ float sh_a[WARPS], sh_b[WARPS], sh_p[WARPS], sh_q[WARPS];

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
        tsm[idx] = k < M ? trans[slot * plane + row + k] : 0.0f;
    }
    __syncthreads();
    const float* tmm = tsm;
    const float* tim = tsm + WIDTH;
    const float* tdm = tsm + 2 * WIDTH;
    const float* tmi = tsm + 3 * WIDTH;
    const float* tii = tsm + 4 * WIDTH;
    const float* tmd = tsm + 5 * WIDTH;
    const float* tdd = tsm + 6 * WIDTH;
    const float* bm = tsm + 7 * WIDTH;

    const int L = lens[s];
    const int8_t* x = xs + offsets[s];
    const float loop = loops[s];
    const float move = moves[s];
    const int base = tid * CHUNK;

    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = move, J = 0.0f, C = 0.0f, ls = 0.0f;
    float score = NEG;

    for (int i = 0; i < L; ++i) {
        const float* e = e_odds + static_cast<size_t>(x[i]) * plane + row;
        {
            const int k = base + CHUNK - 1;
            sh_stay[tid] = Mv[CHUNK - 1] * tmm[k] + Iv[CHUNK - 1] * tim[k] + Dv[CHUNK - 1] * tdm[k];
        }
        __syncthreads();
        const float prev = tid > 0 ? sh_stay[tid - 1] : 0.0f;
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
            sh_a[warp] = ia;
            sh_b[warp] = ib;
        }
        if (lane == 0) {
            sh_p[warp] = pw;
            sh_q[warp] = qw;
        }
        __syncthreads();
        float X = 0.0f, mine = 0.0f, E = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w == warp) mine = X;
            E += sh_p[w] * X + sh_q[w];
            X = sh_a[w] * X + sh_b[w];
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
        ls += logf(total);
        if (i == L - 1) score = logf(C * move + 1e-38f) + ls;
    }
    if (tid == 0) out[pair] = score;
}

template <int THREADS, int CHUNK>
cudaError_t launch(int n_pairs, cudaStream_t st, const void* xs, const void* offsets,
                   const void* lens, const void* loops, const void* moves, const void* pair_seq,
                   const void* pair_prof, const void* e_odds, const void* trans,
                   const void* model_len, int P, int Mp, void* out) {
    const size_t smem = sizeof(float) * 8 * THREADS * CHUNK;
    cudaError_t err = allow_smem(forward_kernel<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    forward_kernel<THREADS, CHUNK><<<n_pairs, THREADS, smem, st>>>(
        static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
        static_cast<const float*>(moves), static_cast<const int32_t*>(pair_seq),
        static_cast<const int32_t*>(pair_prof), static_cast<const float*>(e_odds),
        static_cast<const float*>(trans), static_cast<const int32_t*>(model_len), P, Mp,
        static_cast<float*>(out));
    return cudaGetLastError();
}

}  // namespace

// Scores n_pairs (pair_seq[r], pair_prof[r]) pairs whose profiles all have
// model length <= width (128, 256, ..., 4096); loops/moves are probabilities
// (exp of the length model).  Writes out[r]; returns a CUDA error code.
extern "C" int gecco_forward_pairs(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* pair_seq,
                                   const void* pair_prof, int n_pairs, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, void* out, void* stream) {
    if (n_pairs <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GECCO_LAUNCH(T, C)                                                                     \
    launch<T, C>(n_pairs, st, xs, offsets, lens, loops, moves, pair_seq, pair_prof, e_odds,   \
                 trans, model_len, P, Mp, out)
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
