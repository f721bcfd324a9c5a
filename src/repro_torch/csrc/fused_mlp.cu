// Fused small-MLP forward: the density head relu(x W1 + b1) W2 + b2 and the
// 3-layer color head, weights resident in shared memory.
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py:42 fused_mlp2 (body
// _mlp2_kernel :24) and src/repro/kernels/fused_mlp/kernel.py:62 fused_mlp3
// (body _mlp3_kernel :30).
//
// What bounds it on the H100: at the path's shapes (mlp2 32->64->16,
// mlp3 48->64->64->3, about 6 and 15 flops per byte of activations moved) the
// f32 FMA rate of the CUDA cores.  This port does the arithmetic in plain
// f32 FMA, without tensor cores, so that its numbers match the f32 reference;
// warpgroup MMA is later work.
//
// Design: the TPU kernel's point was fusion -- all layers in one kernel with
// the weights resident, activations never written to device memory between
// layers.  Here one thread computes one point.  Each block first copies every
// weight and bias into shared memory (about 12 KB for mlp2, 30 KB for mlp3 at
// the path's shapes); every thread of a warp then reads the same weight at
// the same time, a broadcast without bank conflicts.  The input row and the
// first hidden layer stay in registers: loops over their indices are unrolled
// to compile-time bounds (DIN_MAX, kHMax, DOUT_MAX) with guards for the
// actual widths, so the arrays never spill to local memory.  Each output is
// the reference's order: the dot product summed over ascending k, then the
// bias added.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHMax = 64;

// Copy `count` floats from global to shared memory with the whole block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

template <int DIN_MAX, int DOUT_MAX>
__global__ void __launch_bounds__(kThreads)
mlp2_kernel(const float* __restrict__ x,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2,
            float* __restrict__ out, int n, int d_in, int hidden, int d_out) {
    extern __shared__ float smem[];
    float* sw1 = smem;
    float* sb1 = sw1 + d_in * hidden;
    float* sw2 = sb1 + hidden;
    float* sb2 = sw2 + hidden * d_out;
    stage(sw1, w1, d_in * hidden);
    stage(sb1, b1, hidden);
    stage(sw2, w2, hidden * d_out);
    stage(sb2, b2, d_out);
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float xr[DIN_MAX];
#pragma unroll
    for (int k = 0; k < DIN_MAX; ++k)
        xr[k] = k < d_in ? x[static_cast<size_t>(i) * d_in + k] : 0.0f;

    float acc[DOUT_MAX];
#pragma unroll
    for (int o = 0; o < DOUT_MAX; ++o) acc[o] = 0.0f;

    for (int j = 0; j < hidden; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < DIN_MAX; ++k)
            if (k < d_in) s += xr[k] * sw1[k * hidden + j];
        const float h = fmaxf(s + sb1[j], 0.0f);
#pragma unroll
        for (int o = 0; o < DOUT_MAX; ++o)
            if (o < d_out) acc[o] += h * sw2[j * d_out + o];
    }
#pragma unroll
    for (int o = 0; o < DOUT_MAX; ++o)
        if (o < d_out) out[static_cast<size_t>(i) * d_out + o] = acc[o] + sb2[o];
}

template <int DIN_MAX, int DOUT_MAX>
__global__ void __launch_bounds__(kThreads)
mlp3_kernel(const float* __restrict__ x,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2,
            const float* __restrict__ w3, const float* __restrict__ b3,
            float* __restrict__ out, int n, int d_in, int h1, int h2, int d_out) {
    extern __shared__ float smem[];
    float* sw1 = smem;
    float* sb1 = sw1 + d_in * h1;
    float* sw2 = sb1 + h1;
    float* sb2 = sw2 + h1 * h2;
    float* sw3 = sb2 + h2;
    float* sb3 = sw3 + h2 * d_out;
    stage(sw1, w1, d_in * h1);
    stage(sb1, b1, h1);
    stage(sw2, w2, h1 * h2);
    stage(sb2, b2, h2);
    stage(sw3, w3, h2 * d_out);
    stage(sb3, b3, d_out);
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float xr[DIN_MAX];
#pragma unroll
    for (int k = 0; k < DIN_MAX; ++k)
        xr[k] = k < d_in ? x[static_cast<size_t>(i) * d_in + k] : 0.0f;

    // first hidden layer, kept in registers (compile-time indices only)
    float a1[kHMax];
#pragma unroll
    for (int j = 0; j < kHMax; ++j) {
        float s = 0.0f;
        if (j < h1) {
#pragma unroll
            for (int k = 0; k < DIN_MAX; ++k)
                if (k < d_in) s += xr[k] * sw1[k * h1 + j];
            s = fmaxf(s + sb1[j], 0.0f);
        }
        a1[j] = s;
    }

    // second hidden layer one unit at a time, folded straight into the head
    float acc[DOUT_MAX];
#pragma unroll
    for (int o = 0; o < DOUT_MAX; ++o) acc[o] = 0.0f;
    for (int j = 0; j < h2; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < kHMax; ++k)
            if (k < h1) s += a1[k] * sw2[k * h2 + j];
        const float a2 = fmaxf(s + sb2[j], 0.0f);
#pragma unroll
        for (int o = 0; o < DOUT_MAX; ++o)
            if (o < d_out) acc[o] += a2 * sw3[j * d_out + o];
    }
#pragma unroll
    for (int o = 0; o < DOUT_MAX; ++o)
        if (o < d_out) out[static_cast<size_t>(i) * d_out + o] = acc[o] + sb3[o];
}

// The compile-time bounds a width is rounded up to: {4, 16} for outputs,
// {32, 64} for inputs.
inline int bucket_out(int d) { return d <= 4 ? 4 : 16; }
inline int bucket_in(int d) { return d <= 32 ? 32 : 64; }

}  // namespace

// x (n, d_in), w1 (d_in, hidden), b1 (hidden,), w2 (hidden, d_out),
// b2 (d_out,), out (n, d_out): f32, contiguous, x @ W layout.
// Limits: d_in <= 64, hidden <= 64, d_out <= 16.
extern "C" int fused_mlp2_fwd(const float* x, const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out,
                              int n, int d_in, int hidden, int d_out,
                              void* stream) {
    if (d_in < 1 || d_in > 64 || hidden < 1 || hidden > kHMax || d_out < 1 ||
        d_out > 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n == 0) return 0;
    const size_t smem =
        sizeof(float) * (d_in * hidden + hidden + hidden * d_out + d_out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (n + kThreads - 1) / kThreads;
    const int bi = bucket_in(d_in), bo = bucket_out(d_out);
#define MLP2(DI, DO)                                                         \
    mlp2_kernel<DI, DO><<<grid, kThreads, smem, s>>>(x, w1, b1, w2, b2, out, \
                                                     n, d_in, hidden, d_out)
    if (bi == 32 && bo == 4) MLP2(32, 4);
    else if (bi == 32) MLP2(32, 16);
    else if (bo == 4) MLP2(64, 4);
    else MLP2(64, 16);
#undef MLP2
    return static_cast<int>(cudaGetLastError());
}

// x (n, d_in), w1 (d_in, h1), b1 (h1,), w2 (h1, h2), b2 (h2,), w3 (h2, d_out),
// b3 (d_out,), out (n, d_out).  Limits: d_in <= 64, h1, h2 <= 64, d_out <= 16.
extern "C" int fused_mlp3_fwd(const float* x, const float* w1, const float* b1,
                              const float* w2, const float* b2, const float* w3,
                              const float* b3, float* out, int n, int d_in,
                              int h1, int h2, int d_out, void* stream) {
    if (d_in < 1 || d_in > 64 || h1 < 1 || h1 > kHMax || h2 < 1 || h2 > kHMax ||
        d_out < 1 || d_out > 16) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n == 0) return 0;
    const size_t smem = sizeof(float) * (d_in * h1 + h1 + h1 * h2 + h2 +
                                         h2 * d_out + d_out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (n + kThreads - 1) / kThreads;
    const int bi = bucket_in(d_in), bo = bucket_out(d_out);
#define MLP3(DI, DO)                                                  \
    mlp3_kernel<DI, DO><<<grid, kThreads, smem, s>>>(                 \
        x, w1, b1, w2, b2, w3, b3, out, n, d_in, h1, h2, d_out)
    if (bi == 32 && bo == 4) MLP3(32, 4);
    else if (bi == 32) MLP3(32, 16);
    else if (bo == 4) MLP3(64, 4);
    else MLP3(64, 16);
#undef MLP3
    return static_cast<int>(cudaGetLastError());
}
