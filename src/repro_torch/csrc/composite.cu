// Volume-rendering composite along each ray (paper Eq. 1, step 4), forward
// and backward.
//
// Replaces: src/repro/kernels/volume_render/kernel.py:35 composite_pallas
// (body _composite_kernel :19), and its backward, the autodiff of the
// reference's `ref.composite` (src/repro/kernels/volume_render/ops.py:49
// _composite_bwd).
//
// What bounds it on the H100: memory.  The forward reads each sample once
// (sigma, delta, t and three colour channels: 24 bytes) for ~16 flops and
// two exponentials and writes five floats per ray; the backward reads the
// same and writes up to 24 bytes of gradients per sample.
//
// Design: a group of G lanes owns one ray, G the power of two >= min(S, 32)
// (a template parameter, picked from S by the host), so a warp holds 32 / G
// rays and its lanes read consecutive samples: the loads of sigma, delta and
// t are contiguous across the warp, and rgb's 12-byte rows are contiguous
// too.  A block of 128 threads takes 128 / G rays, so a 4096-ray chunk is
// 1024 blocks at S = 48.  The group walks its ray in chunks of G samples:
// the optical depth up to each sample is a shuffle scan within the chunk
// plus the running total of the earlier chunks (one register), and the
// weighted sums stay per lane until a butterfly reduction at the end.  The
// arithmetic per sample is the reference's: tau = sigma * delta,
// T = exp(-(cum - tau)), alpha = 1 - exp(-tau), w = T * alpha; only the
// order of the sums differs.  Every order is fixed, so two launches give
// the same bytes.
//
// The backward (one launch) recomputes the forward scan and, with
// v_k = g_color . c_k + g_depth * t_k + g_opacity, writes
//   dL/dtau_k = v_k T_k exp(-tau_k) - S_{>k},  S_{>k} = sum_{j>k} w_j v_j,
// d_sigma = delta dL/dtau, d_delta = sigma dL/dtau, d_rgb = w g_color and
// d_t = w g_depth.  S_{>k} is a suffix scan, walked from the last chunk to
// the first (a reverse shuffle scan within the chunk plus the later chunks'
// total), never a total minus a prefix, which would cancel.  A first walk
// over the chunks stores the optical depth before each chunk in shared
// memory, so the reverse walk recomputes T_k exactly as the forward did.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive prefix sum over the G lanes of a group (lane g = its place).
template <int G>
__device__ __forceinline__ float group_scan(float x, int g) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
        const float y = __shfl_up_sync(kFull, x, o, G);
        if (g >= o) x += y;
    }
    return x;
}

// Inclusive suffix sum over the G lanes of a group.
template <int G>
__device__ __forceinline__ float group_suffix_scan(float x, int g) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
        const float y = __shfl_down_sync(kFull, x, o, G);
        if (g + o < G) x += y;
    }
    return x;
}

// The sum over the G lanes of a group, the same bits in every lane.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o, G);
    return x;
}

// Every lane runs every chunk of its warp's rays (S is the same for all),
// so the shuffles always see the whole warp; lanes past the ray's end or of
// a ray past n_rays carry tau = 0 and contribute nothing.
template <int G>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                 const float* __restrict__ deltas, const float* __restrict__ ts,
                 float* __restrict__ color, float* __restrict__ depth,
                 float* __restrict__ opacity, int n_rays, int n_samples) {
    const int g = threadIdx.x & (G - 1);
    const int ray = (blockIdx.x * kThreads + static_cast<int>(threadIdx.x)) / G;
    const bool live = ray < n_rays;
    const size_t base = static_cast<size_t>(live ? ray : 0) * n_samples;

    float carry = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f, o = 0.0f;
    for (int k0 = 0; k0 < n_samples; k0 += G) {
        const int k = k0 + g;
        float tau = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, t = 0.0f;
        if (live && k < n_samples) {
            const size_t i = base + k;
            tau = sigma[i] * deltas[i];
            t = ts[i];
            r0 = rgb[3 * i + 0];
            r1 = rgb[3 * i + 1];
            r2 = rgb[3 * i + 2];
        }
        const float incl = group_scan<G>(tau, g);
        const float cum = carry + incl;
        const float trans = expf(-(cum - tau));
        const float alpha = 1.0f - expf(-tau);
        const float w = trans * alpha;
        c0 += w * r0;
        c1 += w * r1;
        c2 += w * r2;
        d += w * t;
        o += w;
        carry += __shfl_sync(kFull, incl, G - 1, G);
    }
    c0 = group_sum<G>(c0);
    c1 = group_sum<G>(c1);
    c2 = group_sum<G>(c2);
    d = group_sum<G>(d);
    o = group_sum<G>(o);
    if (live && g == 0) {
        color[3 * ray + 0] = c0;
        color[3 * ray + 1] = c1;
        color[3 * ray + 2] = c2;
        depth[ray] = d;
        opacity[ray] = o;
    }
}

// Dynamic shared memory: (kThreads / G) groups x n_chunks floats, the
// optical depth before each chunk of the group's ray.
template <int G>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                     const float* __restrict__ deltas, const float* __restrict__ ts,
                     const float* __restrict__ g_color, const float* __restrict__ g_depth,
                     const float* __restrict__ g_opacity, float* __restrict__ d_sigma,
                     float* __restrict__ d_rgb, float* __restrict__ d_deltas,
                     float* __restrict__ d_ts, int n_rays, int n_samples) {
    extern __shared__ float chunk_depth[];
    const int g = threadIdx.x & (G - 1);
    const int ray = (blockIdx.x * kThreads + static_cast<int>(threadIdx.x)) / G;
    const bool live = ray < n_rays;
    const size_t base = static_cast<size_t>(live ? ray : 0) * n_samples;
    const int n_chunks = (n_samples + G - 1) / G;
    float* before = chunk_depth + (threadIdx.x / G) * n_chunks;
    float gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f, gd = 0.0f, go = 0.0f;
    if (live) {
        gc0 = g_color[3 * ray + 0];
        gc1 = g_color[3 * ray + 1];
        gc2 = g_color[3 * ray + 2];
        gd = g_depth[ray];
        go = g_opacity[ray];
    }

    // the forward's carries: the optical depth before each chunk
    float carry = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        if (g == 0) before[c] = carry;
        if (c == n_chunks - 1) break;
        const int k = c * G + g;
        float tau = 0.0f;
        if (live && k < n_samples) tau = sigma[base + k] * deltas[base + k];
        carry += __shfl_sync(kFull, group_scan<G>(tau, g), G - 1, G);
    }
    __syncwarp();

    // the chunks from the last to the first, S_{>k} carried in `after`
    float after = 0.0f;
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int k = c * G + g;
        const bool in = live && k < n_samples;
        const size_t i = base + k;
        float s = 0.0f, dl = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, t = 0.0f;
        if (in) {
            s = sigma[i];
            dl = deltas[i];
            t = ts[i];
            r0 = rgb[3 * i + 0];
            r1 = rgb[3 * i + 1];
            r2 = rgb[3 * i + 2];
        }
        const float tau = s * dl;
        const float cum = before[c] + group_scan<G>(tau, g);
        const float trans = expf(-(cum - tau));
        const float e = expf(-tau);
        const float w = trans * (1.0f - e);
        const float v = gc0 * r0 + gc1 * r1 + gc2 * r2 + gd * t + go;
        const float suffix = group_suffix_scan<G>(w * v, g);
        float later = __shfl_down_sync(kFull, suffix, 1, G);
        if (g == G - 1) later = 0.0f;
        const float g_tau = v * trans * e - (after + later);
        after += __shfl_sync(kFull, suffix, 0, G);
        if (in) {
            if (d_sigma) d_sigma[i] = dl * g_tau;
            if (d_deltas) d_deltas[i] = s * g_tau;
            if (d_ts) d_ts[i] = w * gd;
            if (d_rgb) {
                d_rgb[3 * i + 0] = w * gc0;
                d_rgb[3 * i + 1] = w * gc1;
                d_rgb[3 * i + 2] = w * gc2;
            }
        }
    }
}

int group_width(int n_samples) {
    int g = 1;
    while (g < n_samples && g < 32) g <<= 1;
    return g;
}

template <int G>
int launch_fwd(const float* sigma, const float* rgb, const float* deltas, const float* ts,
               float* color, float* depth, float* opacity, int n_rays, int n_samples,
               cudaStream_t stream) {
    constexpr int kRays = kThreads / G;
    const int grid = (n_rays + kRays - 1) / kRays;
    composite_kernel<G><<<grid, kThreads, 0, stream>>>(sigma, rgb, deltas, ts, color, depth,
                                                        opacity, n_rays, n_samples);
    return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_bwd(const float* sigma, const float* rgb, const float* deltas, const float* ts,
               const float* g_color, const float* g_depth, const float* g_opacity,
               float* d_sigma, float* d_rgb, float* d_deltas, float* d_ts, int n_rays,
               int n_samples, cudaStream_t stream) {
    constexpr int kRays = kThreads / G;
    const int grid = (n_rays + kRays - 1) / kRays;
    const size_t smem = sizeof(float) * kRays * ((n_samples + G - 1) / G);
    auto kernel = composite_bwd_kernel<G>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, smem, stream>>>(sigma, rgb, deltas, ts, g_color, g_depth,
                                             g_opacity, d_sigma, d_rgb, d_deltas, d_ts, n_rays,
                                             n_samples);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_BY_GROUP(launch, n_samples, ...)                                   \
    switch (group_width(n_samples)) {                                           \
        case 1: return launch<1>(__VA_ARGS__);                                   \
        case 2: return launch<2>(__VA_ARGS__);                                   \
        case 4: return launch<4>(__VA_ARGS__);                                   \
        case 8: return launch<8>(__VA_ARGS__);                                   \
        case 16: return launch<16>(__VA_ARGS__);                                 \
        default: return launch<32>(__VA_ARGS__);                                 \
    }

// sigma, deltas, ts (n_rays, n_samples); rgb (n_rays, n_samples, 3);
// color (n_rays, 3), depth and opacity (n_rays,): f32, contiguous.
extern "C" int composite_fwd(const float* sigma, const float* rgb,
                             const float* deltas, const float* ts, float* color,
                             float* depth, float* opacity, int n_rays,
                             int n_samples, void* stream) {
    if (n_samples < 1 || n_rays < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rays == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    REPRO_BY_GROUP(launch_fwd, n_samples, sigma, rgb, deltas, ts, color, depth, opacity,
                   n_rays, n_samples, s)
}

// The forward's inputs, and g_color (n_rays, 3), g_depth and g_opacity
// (n_rays,) -> d_sigma, d_deltas, d_ts (n_rays, n_samples) and d_rgb
// (n_rays, n_samples, 3), each written only where its pointer is not null.
// f32, contiguous.
extern "C" int composite_bwd(const float* sigma, const float* rgb, const float* deltas,
                             const float* ts, const float* g_color, const float* g_depth,
                             const float* g_opacity, float* d_sigma, float* d_rgb,
                             float* d_deltas, float* d_ts, int n_rays, int n_samples,
                             void* stream) {
    if (n_samples < 1 || n_rays < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rays == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    REPRO_BY_GROUP(launch_bwd, n_samples, sigma, rgb, deltas, ts, g_color, g_depth,
                   g_opacity, d_sigma, d_rgb, d_deltas, d_ts, n_rays, n_samples, s)
}
