// Fused small-MLP forward: the density head relu(x W1 + b1) W2 + b2 and the
// 3-layer color head, weights resident in shared memory.
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py:42 fused_mlp2 (body
// _mlp2_kernel :24) and src/repro/kernels/fused_mlp/kernel.py:62 fused_mlp3
// (body _mlp3_kernel :30).
//
// What bounds it on the H100: at the path's shapes (mlp2 32->64->16,
// mlp3 48->64->64->3, about 6 and 15 flops per byte of activations moved)
// f32 operations.  The TPU kernel's point was fusion -- all layers in one
// kernel with the weights resident, activations never written to device
// memory between layers -- and both kernels keep it.
//
// mlp2 design: one thread computes one point in plain f32 FMA on the CUDA
// cores.  Each block first copies every weight and bias into shared memory
// (about 12 KB at the path's shapes); every thread of a warp then reads the
// same weight at the same time, a broadcast without bank conflicts.  The
// input row stays in registers: loops over its indices are unrolled to
// compile-time bounds (DIN_MAX, DOUT_MAX) with guards for the actual widths.
// Each output is the reference's order: the dot product summed over
// ascending k, then the bias added.  Every FMA pairs with a shared-memory
// load of a weight, which caps it near a quarter of the f32 rate.
//
// mlp3 design: the three layers run on the tensor cores through
// mlp_tile.cuh (split TF32, f32-class accuracy).  Each block packs every
// weight once, pre-split into B fragments (about 60 KB at 48-64-64-3), and
// stays resident: each of its warps loops over 16-point tiles in a fixed
// stride.  A warp streams its next tile's inputs into shared memory with
// cp.async while it computes the current one (double buffering), runs layer
// 1 into its hidden tile, layer 2 in place over it (one warp unit covers
// all 16 rows and every column, so the tile is read in full before it is
// written), and layer 3 straight to the outputs.  A warp only ever touches
// its own rows, so the layers need no block barrier.  Rows past N are
// zero-filled by the copy and never written; input widths that are not a
// multiple of 4 (31 in the Instant-NGP color head) are copied 4 bytes at a
// time, and columns past d_in are masked in the product, not padded in
// device memory.  Two blocks of 4 warps fit on an SM.
#include "common.cuh"
#include "mlp_tile.cuh"

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

constexpr int kMlp3Warps = 4;       // warps per mlp3 block
constexpr int kTile = 16;           // points per warp tile

// Shared memory of an mlp3 block, in floats: the packed weights, the biases
// (each rounded up to 4 floats, keeping 16-byte alignment), then per warp
// two input tiles and one hidden tile.
struct Mlp3Layout {
    int ld_x, ld_h;
    size_t w1, w2, w3, b1, b2, b3, warps, per_warp, floats;

    __host__ __device__ Mlp3Layout(int d_in, int h1, int h2, int d_out) {
        using mlp_tile::Packed;
        ld_x = mlp_tile::act_ld(d_in);
        ld_h = mlp_tile::act_ld(h1 > h2 ? h1 : h2);
        size_t at = 0;
        w1 = at; at += Packed::floats(d_in, h1);
        w2 = at; at += Packed::floats(h1, h2);
        w3 = at; at += Packed::floats(h2, d_out);
        b1 = at; at += (h1 + 3) / 4 * 4;
        b2 = at; at += (h2 + 3) / 4 * 4;
        b3 = at; at += (d_out + 3) / 4 * 4;
        warps = at;
        per_warp = static_cast<size_t>(kTile) * (2 * ld_x + ld_h);
        floats = at + kMlp3Warps * per_warp;
    }
};

// The tile's rows [row0, row0 + 16) of x (n, d_in) into dst (row stride
// ld), by one warp; rows past n are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x, int row0,
                                          int n, int d_in, int ld) {
    const int lane = threadIdx.x & 31;
    if (VEC) {
        const int q4 = d_in >> 2;
        for (int e = lane; e < kTile * q4; e += 32) {
            const int r = e / q4, q = e - r * q4;
            const bool ok = row0 + r < n;
            const float* src = ok ? x + static_cast<size_t>(row0 + r) * d_in + q * 4 : x;
            mlp_tile::cp_async<16>(dst + r * ld + q * 4, src, ok);
        }
    } else {
        for (int e = lane; e < kTile * d_in; e += 32) {
            const int r = e / d_in, c = e - r * d_in;
            const bool ok = row0 + r < n;
            const float* src = ok ? x + static_cast<size_t>(row0 + r) * d_in + c : x;
            mlp_tile::cp_async<4>(dst + r * ld + c, src, ok);
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(kMlp3Warps * 32)
mlp3_kernel(const float* __restrict__ x,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2,
            const float* __restrict__ w3, const float* __restrict__ b3,
            float* __restrict__ out, int n, int d_in, int h1, int h2, int d_out) {
    using mlp_tile::Strided;
    extern __shared__ __align__(16) float smem3[];
    const Mlp3Layout lay(d_in, h1, h2, d_out);
    const mlp_tile::Packed W1 = mlp_tile::pack(smem3 + lay.w1, w1, d_in, h1);
    const mlp_tile::Packed W2 = mlp_tile::pack(smem3 + lay.w2, w2, h1, h2);
    const mlp_tile::Packed W3 = mlp_tile::pack(smem3 + lay.w3, w3, h2, d_out);
    float* sb1 = smem3 + lay.b1;
    float* sb2 = smem3 + lay.b2;
    float* sb3 = smem3 + lay.b3;
    stage(sb1, b1, h1);
    stage(sb2, b2, h2);
    stage(sb3, b3, d_out);
    const int warp = threadIdx.x >> 5;
    float* xbuf = smem3 + lay.warps + warp * lay.per_warp;
    float* hid = xbuf + 2 * kTile * lay.ld_x;
    const int ld_x = lay.ld_x, ld_h = lay.ld_h;
    __syncthreads();

    const int n_tiles = (n + kTile - 1) / kTile;
    const int stride = gridDim.x * kMlp3Warps;
    int tile = blockIdx.x * kMlp3Warps + warp;
    if (tile < n_tiles) load_tile<VEC>(xbuf, x, tile * kTile, n, d_in, ld_x);
    mlp_tile::commit();
    for (int it = 0; tile < n_tiles; tile += stride, ++it) {
        const float* xs = xbuf + (it & 1) * kTile * ld_x;
        if (tile + stride < n_tiles)
            load_tile<VEC>(xbuf + ((it + 1) & 1) * kTile * ld_x, x, (tile + stride) * kTile, n,
                           d_in, ld_x);
        mlp_tile::commit();        // possibly empty: keeps one group per tile
        mlp_tile::wait<1>();       // this tile's inputs have landed
        __syncwarp();
        const int row0 = tile * kTile;
        mlp_tile::gemm<8>(Strided<>{xs, ld_x, 1, kTile, d_in}, W1, kTile, h1, d_in,
                          [&](int r, int c, float v) {
                              hid[r * ld_h + c] = fmaxf(v + sb1[c], 0.0f); },
                          0, 1);
        __syncwarp();
        mlp_tile::gemm<8>(Strided<>{hid, ld_h, 1, kTile, h1}, W2, kTile, h2, h1,
                          [&](int r, int c, float v) {
                              hid[r * ld_h + c] = fmaxf(v + sb2[c], 0.0f); },
                          0, 1);
        __syncwarp();
        mlp_tile::gemm<2>(Strided<>{hid, ld_h, 1, kTile, h2}, W3, kTile, d_out, h2,
                          [&](int r, int c, float v) {
                              if (row0 + r < n)
                                  out[static_cast<size_t>(row0 + r) * d_out + c] = v + sb3[c];
                          },
                          0, 1);
        __syncwarp();              // the next tile's layer 1 rewrites `hid`
    }
    mlp_tile::wait<0>();
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
    const size_t smem = sizeof(float) * Mlp3Layout(d_in, h1, h2, d_out).floats;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int tiles = (n + kTile - 1) / kTile;
    const int wanted = (tiles + kMlp3Warps - 1) / kMlp3Warps;
    const int grid = wanted < 2 * sms ? wanted : 2 * sms;     // two blocks an SM
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const auto kernel = vec ? mlp3_kernel<true> : mlp3_kernel<false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kMlp3Warps * 32, smem, s>>>(x, w1, b1, w2, b2, w3, b3, out, n, d_in, h1,
                                               h2, d_out);
    return static_cast<int>(cudaGetLastError());
}
