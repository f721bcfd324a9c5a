// Volume-rendering composite along each ray (paper Eq. 1, step 4).
//
// Replaces: src/repro/kernels/volume_render/kernel.py:35 composite_pallas
// (body _composite_kernel :19).
//
// What bounds it on the H100: memory.  Each sample is read once (sigma,
// delta, t and three colour channels: 24 bytes) for ~15 flops and two
// exponentials; only five floats per ray are written.
//
// Design: the TPU kernel kept a ray block's whole sample axis in VMEM and ran
// the transmittance prefix as a vector cumsum.  Here one thread owns one ray
// and walks its S samples in order, carrying the running optical depth in a
// register, so the per-sample (R, S) intermediates (tau, transmittance,
// weights) never exist in memory at all.  The arithmetic keeps the
// reference's form exactly: tau = sigma * delta, cum += tau,
// T = exp(-(cum - tau)), alpha = 1 - exp(-tau), w = T * alpha, then the
// weighted sums of colour, t and 1.  Written in CUDA rather than Triton so
// that all of the port's kernels build and load the same way.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                 const float* __restrict__ deltas, const float* __restrict__ ts,
                 float* __restrict__ color, float* __restrict__ depth,
                 float* __restrict__ opacity, int n_rays, int n_samples) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;
    const size_t base = static_cast<size_t>(r) * n_samples;

    float cum = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f, o = 0.0f;
    for (int k = 0; k < n_samples; ++k) {
        const size_t i = base + k;
        const float tau = sigma[i] * deltas[i];
        cum += tau;
        const float trans = expf(-(cum - tau));
        const float alpha = 1.0f - expf(-tau);
        const float w = trans * alpha;
        c0 += w * rgb[3 * i + 0];
        c1 += w * rgb[3 * i + 1];
        c2 += w * rgb[3 * i + 2];
        d += w * ts[i];
        o += w;
    }
    color[3 * r + 0] = c0;
    color[3 * r + 1] = c1;
    color[3 * r + 2] = c2;
    depth[r] = d;
    opacity[r] = o;
}

}  // namespace

// sigma, deltas, ts (n_rays, n_samples); rgb (n_rays, n_samples, 3);
// color (n_rays, 3), depth and opacity (n_rays,): f32, contiguous.
extern "C" int composite_fwd(const float* sigma, const float* rgb,
                             const float* deltas, const float* ts, float* color,
                             float* depth, float* opacity, int n_rays,
                             int n_samples, void* stream) {
    if (n_samples < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rays == 0) return 0;
    const int grid = (n_rays + kThreads - 1) / kThreads;
    composite_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        sigma, rgb, deltas, ts, color, depth, opacity, n_rays, n_samples);
    return static_cast<int>(cudaGetLastError());
}
