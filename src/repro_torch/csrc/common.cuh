// Shared by every kernel source of repro_torch.  Each source builds into its
// own shared library with a plain C interface (loaded from Python with
// ctypes), so each library exports its own copy of the error-string lookup
// that the Python wrappers use to report a failed launch.  The table-row
// loads serve the three gathers of table rows (hash_encode.cu,
// fused_encode.cu, fused_step.cu).
//
// Tables come in three element types (FieldConfig.grid_dtype): f32, bf16 and
// f16.  A 2-byte row of F elements is loaded as its raw bits in one load
// (2, 4, 8 or 16 bytes) and widened to f32 in registers: a bf16 value is the
// top half of an f32 and an f16 converts exactly, so every kernel computes
// on the same f32 values as on the table's f32 copy.  The C entry points
// take the element type as a code (`TableType`) and dispatch to a template
// instance per type; the wrappers pass the code of the table's own dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The element type of a table, as the wrappers pass it.
enum TableType { kTableF32 = 0, kTableBF16 = 1, kTableF16 = 2 };

template <class T>
struct TypeTag { using type = T; };

// fn(TypeTag<T>{}) for the element type T of `table_type`; an unknown code
// is cudaErrorInvalidValue.
template <class Fn>
int with_table_type(int table_type, Fn&& fn) {
    switch (table_type) {
        case kTableF32: return fn(TypeTag<float>{});
        case kTableBF16: return fn(TypeTag<__nv_bfloat16>{});
        case kTableF16: return fn(TypeTag<__half>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// One 2-byte element's bits (in the low 16 bits of `bits`) as f32, exactly.
template <class T>
__device__ __forceinline__ float widen(uint32_t bits);
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t bits) {
    return __uint_as_float(bits << 16);
}
template <>
__device__ __forceinline__ float widen<__half>(uint32_t bits) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

// A row of F 2-byte elements held in words (two elements a word, the lower
// address in the low half) as f32.
template <class T, int F>
__device__ __forceinline__ void widen_row(const uint32_t* w, float (&v)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = widen<T>(f & 1 ? w[f >> 1] >> 16 : w[f >> 1] & 0xffffu);
}

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

// One table row of F 2-byte elements at p (aligned to 2F bytes) into v as
// f32: one load of its 2F bytes through the read-only path, L2 policy as
// above.
template <int F, class T>
__device__ __forceinline__ void load_row(const T* p, uint64_t policy, float (&v)[F]) {
    static_assert(sizeof(T) == 2, "2-byte table elements");
    uint32_t w[(F + 1) / 2];
    if constexpr (F == 1) {
        unsigned short h;
        asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(h) : "l"(p), "l"(policy));
        w[0] = h;
    } else if constexpr (F == 2) {
        asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(w[0]) : "l"(p), "l"(policy));
    } else if constexpr (F == 4) {
        asm("ld.global.nc.L2::cache_hint.v2.b32 {%0, %1}, [%2], %3;"
            : "=r"(w[0]), "=r"(w[1]) : "l"(p), "l"(policy));
    } else {
        static_assert(F == 8, "F in {1, 2, 4, 8}");
        asm("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
            : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p), "l"(policy));
    }
    widen_row<T, F>(w, v);
}
