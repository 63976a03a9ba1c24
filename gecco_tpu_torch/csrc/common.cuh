// Shared helpers of the profile-HMM kernels (sm_90a, plain C interface).
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace gecco {

// Log-space stand-in for log(0), the same value the JAX package uses.
constexpr float NEG = -1e30f;
constexpr float LOG_HALF = -0.69314718055994530942f;
constexpr int K_ALPHA = 21;  // 20 amino acids + the degenerate residue

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Order-preserving float <-> uint encoding for shared-memory atomicMax.
__device__ __forceinline__ unsigned ordered_bits(float f) {
    unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_float(unsigned u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Maximum over a warp in one instruction (redux.sync on the ordered
// encoding); exact, like warp_max.
__device__ __forceinline__ float warp_max_redux(float v) {
    return ordered_float(__reduce_max_sync(0xffffffffu, ordered_bits(v)));
}

// The residues of one sequence as a whole warp reads them: aligned 32-bit
// words that every lane loads from the same address (one broadcast
// transaction), the word after the current one already in flight.  Call
// next() once per residue, at most L times, from every lane alike.
struct ResidueStream {
    const uint32_t* word;  // the word holding the next residue
    const uint32_t* last;  // the word holding residue L-1
    uint32_t cur, nxt;
    int shift;             // bit offset of the next residue in cur

    __device__ __forceinline__ ResidueStream(const int8_t* x, int L) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(x);
        word = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
        last = reinterpret_cast<const uint32_t*>((a + (L > 0 ? L - 1 : 0)) & ~uintptr_t(3));
        shift = static_cast<int>(a & 3) * 8;
        cur = L > 0 ? __ldg(word) : 0u;
        nxt = L > 0 && word < last ? __ldg(word + 1) : 0u;
    }

    __device__ __forceinline__ int next() {
        const int r = static_cast<int>((cur >> shift) & 0xffu);
        shift += 8;
        if (shift == 32) {
            shift = 0;
            cur = nxt;
            ++word;
            nxt = word < last ? __ldg(word + 1) : 0u;
        }
        return r;
    }
};

// The same read backwards: residues L-1, L-2, ..., 0 (the Backward
// passes).  Call next() at most L times.
struct ResidueStreamRev {
    const uint32_t* word;   // the word holding the next residue
    const uint32_t* first;  // the word holding residue 0
    uint32_t cur, nxt;
    int shift;

    __device__ __forceinline__ ResidueStreamRev(const int8_t* x, int L) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(x);
        const uintptr_t top = a + (L > 0 ? L - 1 : 0);
        first = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
        word = reinterpret_cast<const uint32_t*>(top & ~uintptr_t(3));
        shift = static_cast<int>(top & 3) * 8;
        cur = L > 0 ? __ldg(word) : 0u;
        nxt = L > 0 && word > first ? __ldg(word - 1) : 0u;
    }

    __device__ __forceinline__ int next() {
        const int r = static_cast<int>((cur >> shift) & 0xffu);
        shift -= 8;
        if (shift < 0) {
            shift = 24;
            cur = nxt;
            --word;
            nxt = word > first ? __ldg(word - 1) : 0u;
        }
        return r;
    }
};

// The rows of a domain-definition launch (kernels D-G): row r scores
// sequence seq[r] against profile prof[r].  Per-row outputs are padded to
// `stride` residues.  Loops and moves are probabilities.
struct RowArgs {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const int32_t* seq;
    const int32_t* prof;
    const float* e_odds;     // [21, P, Mp]
    const float* trans;      // [8, P, Mp]
    const int32_t* model_len;
    int P, Mp, n_rows, stride;
};

inline RowArgs make_row_args(const void* xs, const void* offsets, const void* lens,
                             const void* loops, const void* moves, const void* seq,
                             const void* prof, int n_rows, const void* e_odds, const void* trans,
                             const void* model_len, int P, int Mp, int stride) {
    RowArgs a;
    a.xs = static_cast<const int8_t*>(xs);
    a.offsets = static_cast<const int64_t*>(offsets);
    a.lens = static_cast<const int32_t*>(lens);
    a.loops = static_cast<const float*>(loops);
    a.moves = static_cast<const float*>(moves);
    a.seq = static_cast<const int32_t*>(seq);
    a.prof = static_cast<const int32_t*>(prof);
    a.e_odds = static_cast<const float*>(e_odds);
    a.trans = static_cast<const float*>(trans);
    a.model_len = static_cast<const int32_t*>(model_len);
    a.P = P;
    a.Mp = Mp;
    a.n_rows = n_rows;
    a.stride = stride;
    return a;
}

// One row's sequence and profile, as a block sees them.
struct Row {
    const int8_t* x;   // residues
    int L, M;          // sequence and model length
    float loop, move;
    size_t plane, base;  // bank plane size P*Mp; offset of the profile's row
};

__device__ __forceinline__ Row load_row(const RowArgs& a, int r) {
    Row row;
    const int s = a.seq[r];
    const int p = a.prof[r];
    row.x = a.xs + a.offsets[s];
    row.L = a.lens[s];
    row.M = a.model_len[p];
    row.loop = a.loops[s];
    row.move = a.moves[s];
    row.plane = static_cast<size_t>(a.P) * a.Mp;
    row.base = static_cast<size_t>(p) * a.Mp;
    return row;
}

// Emission odds of residue i of the row, node 0 (read with __ldg, k < M).
__device__ __forceinline__ const float* emission_row(const float* e_odds, const Row& row, int i) {
    return e_odds + static_cast<size_t>(row.x[i]) * row.plane + row.base;
}

// Copy n_planes consecutive [P, Mp] planes of a profile's row into
// dst[n_planes][WIDTH], zero past the model length.  No barrier.
template <int THREADS, int WIDTH>
__device__ __forceinline__ void stage_planes(float* dst, const float* src, int n_planes,
                                             const Row& row) {
    for (int idx = threadIdx.x; idx < n_planes * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        dst[idx] = k < row.M ? src[slot * row.plane + row.base + k] : 0.0f;
    }
}

// Set the dynamic shared-memory cap of a kernel to `bytes`: dynamic and
// static shared memory together may exceed the default 48 KB only above
// an explicit cap, even where the dynamic part alone does not.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace gecco

// Instantiate LAUNCH(THREADS, CHUNK) for a node width of 128 ... 4096 with
// the thread shapes of the Forward/Backward kernels (CHUNK nodes a thread);
// sets `err`.
#define GECCO_DISPATCH_WIDTH(width, LAUNCH)                     \
    switch (width) {                                            \
        case 128: err = LAUNCH(32, 4); break;                   \
        case 256: err = LAUNCH(64, 4); break;                   \
        case 512: err = LAUNCH(128, 4); break;                  \
        case 1024: err = LAUNCH(256, 4); break;                 \
        case 2048: err = LAUNCH(256, 8); break;                 \
        case 4096: err = LAUNCH(256, 16); break;                \
        default: err = cudaErrorInvalidValue;                   \
    }
