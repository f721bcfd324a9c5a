// Shared by every kernel source of repro_torch.  Each source builds into its
// own shared library with a plain C interface (loaded from Python with
// ctypes), so each library exports its own copy of the error-string lookup
// that the Python wrappers use to report a failed launch.  The table-row
// loads serve the two encodes' gathers (hash_encode.cu, fused_encode.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// L2 policy for table rows that many blocks gather: keep them (evict-last)
// while streamed data passes through.
__device__ __forceinline__ uint64_t table_policy() {
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
    return policy;
}

// One table row of F floats at p (aligned to its vector width) into v.
template <int F>
__device__ __forceinline__ void load_row(const float* p, uint64_t policy, float (&v)[F]);

template <>
__device__ __forceinline__ void load_row<1>(const float* p, uint64_t policy, float (&v)[1]) {
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v[0]) : "l"(p), "l"(policy));
}
template <>
__device__ __forceinline__ void load_row<2>(const float* p, uint64_t policy, float (&v)[2]) {
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v[0]), "=f"(v[1]) : "l"(p), "l"(policy));
}
template <>
__device__ __forceinline__ void load_row<4>(const float* p, uint64_t policy, float (&v)[4]) {
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "l"(p), "l"(policy));
}
template <>
__device__ __forceinline__ void load_row<8>(const float* p, uint64_t policy, float (&v)[8]) {
    load_row<4>(p, policy, *reinterpret_cast<float(*)[4]>(&v[0]));
    load_row<4>(p + 4, policy, *reinterpret_cast<float(*)[4]>(&v[4]));
}
