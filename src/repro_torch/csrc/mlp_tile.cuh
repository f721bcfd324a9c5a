// Small dense layers on Hopper's tensor cores, shared by the kernels whose
// work is the field's MLPs (fused_mlp.cu: both heads; fused_step.cu: the fused
// backward's recompute, data gradients and weight gradients).
//
// What bounds it: f32 operations.  At the field's widths (K, N <= 64) a
// layer does 2*K*N flops for 4*(K+N) bytes of activations, far above the
// card's balance point, and f32 FMA on the CUDA cores caps a kernel at
// 67 TFLOP/s -- less in practice, because every FMA of a one-point-per-
// thread loop pairs with a shared-memory load of a weight.  The tensor
// cores take a 16x8x8 product in one instruction (mma.sync m16n8k8, TF32
// inputs, f32 sums) at 495 TFLOP/s; in split TF32 below, three of them per
// multiply-add, an f32-class product at 165 TFLOP/s, 2.5 times the CUDA
// cores' f32 rate.
//
// Why split TF32.  TF32 keeps 10 mantissa bits, about three decimal digits:
// a plain TF32 product misses the kernels' tolerances against the f32
// plain versions (1e-5 absolute on O(1) MLP outputs).  Each operand is
// split as a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi),
// and the sum takes a_hi*b_hi + a_hi*b_lo + a_lo*b_hi (the dropped
// a_lo*b_lo is below 2^-22 of the product): f32-class accuracy for three
// tensor-core products.  Each of the three accumulates on its own over k
// and they join once at the end, the two small ones first.
//
// Determinism: every sum runs over k in ascending steps of 8 inside one
// warp, in a fixed order that no scheduling changes; no atomics.  So two
// launches on the same inputs give the same bits.
//
// The routine `gemm` computes C (M x N) = A (M x K) * B (K x N) and hands
// every element to an epilogue functor epi(row, col, value).  Operands are
// loaders: `Strided` reads element (i, k) of a shared-memory matrix at
// p[i*rs + k*cs] and splits it as it loads (so X*W, G*W^T and X^T*G are one
// routine with other strides), `Packed` reads a weight pre-split into the
// B-fragment order once per block (one 16-byte load per lane and fragment).
// The output is cut into units of one 16-row tile by NG 8-column tiles;
// the warps given to the call take the units round-robin, so every warp of
// a block shares the work (warp, n_warps = threadIdx.x / 32, blockDim.x /
// 32), or one warp works alone on rows it owns (0, 1).
#pragma once

#include <stdint.h>

namespace mlp_tile {

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to about 2^-22 relative, each part a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on one 16x8x8 tile (TF32 operands, f32 sums).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element (i, k) of a rows x cols shared-memory matrix at p[i*rs + k*cs];
// reads outside it give 0, and RELU gives max(x, 0) (an activation kept as
// its pre-activation).
template <bool RELU = false>
struct Strided {
    const float* p;
    int rs, cs, rows, cols;

    __device__ __forceinline__ float at(int i, int k) const {
        const float v = (i < rows && k < cols) ? p[i * rs + k * cs] : 0.0f;
        return RELU ? fmaxf(v, 0.0f) : v;
    }
    // Element (i, k) of a tile known to lie inside the matrix.
    __device__ __forceinline__ float in(int i, int k) const {
        const float v = p[i * rs + k * cs];
        return RELU ? fmaxf(v, 0.0f) : v;
    }
    // A fragment of the 16x8 tile at (r0, k0): lane (g, t) holds (g, t),
    // (g+8, t), (g, t+4), (g+8, t+4).  The bounds are checked per element
    // only on a tile that crosses the matrix's edge (the same for the warp).
    __device__ __forceinline__ void a_frag(int r0, int k0, int g, int t, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) const {
        float v[4];
        if (r0 + 16 <= rows && k0 + 8 <= cols) {
            v[0] = in(r0 + g, k0 + t);
            v[1] = in(r0 + g + 8, k0 + t);
            v[2] = in(r0 + g, k0 + t + 4);
            v[3] = in(r0 + g + 8, k0 + t + 4);
        } else {
            v[0] = at(r0 + g, k0 + t);
            v[1] = at(r0 + g + 8, k0 + t);
            v[2] = at(r0 + g, k0 + t + 4);
            v[3] = at(r0 + g + 8, k0 + t + 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
    }
    // B fragment of the 8x8 tile at (k0, c0): lane (g, t) holds (t, g) and
    // (t+4, g).
    __device__ __forceinline__ void b_frag(int k0, int c0, int g, int t, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) const {
        float v[2];
        if (k0 + 8 <= rows && c0 + 8 <= cols) {
            v[0] = in(k0 + t, c0 + g);
            v[1] = in(k0 + t + 4, c0 + g);
        } else {
            v[0] = at(k0 + t, c0 + g);
            v[1] = at(k0 + t + 4, c0 + g);
        }
        split(v[0], hi[0], lo[0]);
        split(v[1], hi[1], lo[1]);
    }
};

// A weight W (K x N, row-major in device memory) pre-split into B
// fragments: for k-step s and column tile j, lane l's (hi0, hi1, lo0, lo1)
// at p[((s * n_tiles + j) * 32 + l) * 4].  Zero outside K x N.
struct Packed {
    const float* p;
    int n_tiles;

    __host__ __device__ static int floats(int k, int n) {
        return ((k + 7) / 8) * ((n + 7) / 8) * 128;
    }
    __device__ __forceinline__ void b_frag(int k0, int c0, int g, int t, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) const {
        const int lane = g * 4 + t;
        const float4 v = *reinterpret_cast<const float4*>(
            p + (((k0 >> 3) * n_tiles + (c0 >> 3)) * 32 + lane) * 4);
        hi[0] = __float_as_uint(v.x);
        hi[1] = __float_as_uint(v.y);
        lo[0] = __float_as_uint(v.z);
        lo[1] = __float_as_uint(v.w);
    }
};

// Pack W (k x n, row-major, device memory) into dst (Packed::floats(k, n)
// floats of shared memory, 16-byte aligned), with the whole block; each
// thread issues kPackBatch entries' loads before it splits and stores them.
// Call before a __syncthreads().
constexpr int kPackBatch = 8;

__device__ inline Packed pack(float* dst, const float* __restrict__ w, int k, int n) {
    const int n_tiles = (n + 7) / 8, total = ((k + 7) / 8) * n_tiles * 32;
    for (int e0 = threadIdx.x; e0 < total; e0 += kPackBatch * blockDim.x) {
        float b0[kPackBatch], b1[kPackBatch];
#pragma unroll
        for (int u = 0; u < kPackBatch; ++u) {
            const int e = e0 + u * blockDim.x;
            const int lane = e & 31, tile = e >> 5;
            const int s = tile / n_tiles, j = tile - s * n_tiles;
            const int col = j * 8 + (lane >> 2), k0 = s * 8 + (lane & 3), k1 = k0 + 4;
            const bool in = e < total && col < n;
            b0[u] = (in && k0 < k) ? w[k0 * n + col] : 0.0f;
            b1[u] = (in && k1 < k) ? w[k1 * n + col] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kPackBatch; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e < total) {
                uint32_t h0, l0, h1, l1;
                split(b0[u], h0, l0);
                split(b1[u], h1, l1);
                *reinterpret_cast<float4*>(dst + e * 4) =
                    make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                                __uint_as_float(l1));
            }
        }
    }
    return Packed{dst, n_tiles};
}

// C (m x n) = A (m x k) * B (k x n), each element handed to epi(row, col,
// value).  Units of 16 rows x NG*8 columns, taken round-robin by the warps
// warp, warp + n_warps, ... of the caller; every lane of a warp must call.
// A row or column of a unit past m or n is computed on zeros and never
// handed to epi.
template <int NG, class A, class B, class Epi>
__device__ __forceinline__ void gemm(const A& a, const B& b, int m, int n, int k, Epi epi,
                                     int warp, int n_warps) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int m_tiles = (m + 15) >> 4, n_groups = (n + NG * 8 - 1) / (NG * 8);
    for (int unit = warp; unit < m_tiles * n_groups; unit += n_warps) {
        const int r0 = (unit / n_groups) * 16, c0 = (unit % n_groups) * NG * 8;
        // three accumulators per column tile (a_hi b_hi, a_lo b_hi, a_hi b_lo),
        // each product of a k-step issued for every tile before the next
        // product: an mma that waits on the one before it stalls the warp for
        // the tensor cores' whole latency, so no two dependent ones are
        // issued back to back
        float big[NG][4], lohi[NG][4], hilo[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[j][e] = lohi[j][e] = hilo[j][e] = 0.0f;
#pragma unroll 2
        for (int k0 = 0; k0 < k; k0 += 8) {
            uint32_t ah[4], al[4], bh[NG][2], bl[NG][2];
            a.a_frag(r0, k0, g, t, ah, al);
#pragma unroll
            for (int j = 0; j < NG; ++j)
                if (c0 + j * 8 < n) b.b_frag(k0, c0 + j * 8, g, t, bh[j], bl[j]);
#pragma unroll
            for (int j = 0; j < NG; ++j)           // the tile test is the same for every lane
                if (c0 + j * 8 < n) mma(lohi[j], al, bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < NG; ++j)
                if (c0 + j * 8 < n) mma(hilo[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
            for (int j = 0; j < NG; ++j)
                if (c0 + j * 8 < n) mma(big[j], ah, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = r0 + g + (e >> 1) * 8, col = c0 + j * 8 + 2 * t + (e & 1);
                if (row < m && col < n)
                    epi(row, col, __fadd_rn(big[j][e], __fadd_rn(lohi[j][e], hilo[j][e])));
            }
        }
    }
}

// Asynchronous copies from device to shared memory (cp.async): `bytes` of
// 4 or 16; a false `pred` fills the destination with zeros and reads
// nothing.  commit() closes a group of copies, wait<N>() waits until at most
// N groups are in flight.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? BYTES : 0;
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                     "r"(n));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                     "r"(n));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Row stride of an activation tile n wide: a multiple of 4 that is an odd
// multiple of 4, so that the eight rows of an A fragment fall in eight
// different bank quads.
__host__ __device__ inline int act_ld(int n) {
    const int ld = (n + 3) / 4 * 4;
    return ((ld / 4) & 1) ? ld : ld + 4;
}

// Row stride of a weight staged for Strided B reads (k rows of n): an odd
// multiple of 8, so that the four rows of a B fragment fall in four
// different bank octets.
__host__ __device__ inline int weight_ld(int n) {
    const int ld = (n + 7) / 8 * 8;
    return ((ld / 8) & 1) ? ld : ld + 8;
}

}  // namespace mlp_tile
