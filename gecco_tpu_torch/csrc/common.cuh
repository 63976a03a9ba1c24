// Shared helpers of the profile-HMM kernels (sm_90a, plain C interface).
#pragma once

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

// Raise the dynamic shared-memory cap of a kernel when it needs more
// than the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace gecco
