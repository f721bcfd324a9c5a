// Fused small-MLP forward: the density head relu(x W1 + b1) W2 + b2 and the
// 3-layer color head, weights resident in shared memory, products on the
// tensor cores.
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py:42 fused_mlp2 (body
// _mlp2_kernel :24) and src/repro/kernels/fused_mlp/kernel.py:62 fused_mlp3
// (body _mlp3_kernel :30).
//
// What bounds it on the H100: at the path's shapes (mlp2 32->64->16,
// mlp3 48->64->64->3, about 6 and 15 flops per byte of activations moved)
// operations.  The TPU kernel's point was fusion -- all layers in one
// kernel with the weights resident, activations never written to device
// memory between layers -- and the kernel keeps it.
//
// Design: one kernel template, `mlp_kernel<NL>`, serves both heads (NL = 2
// or 3 layers).  The layers run on the tensor cores through mlp_tile.cuh
// (split TF32, f32-class accuracy).  Each block packs every weight once,
// pre-split into B fragments (about 24 KB at 32-64-16, 60 KB at
// 48-64-64-3), and stays resident: each of its warps loops over 16-point
// tiles in a fixed stride.  A warp streams its next tile's inputs into
// shared memory with cp.async while it computes the current one (double
// buffering), runs the hidden layers into its hidden tile (a layer after
// the first in place over it: one warp unit covers all 16 rows and every
// column, so the tile is read in full before it is written), and the last
// layer straight to the outputs.  A warp only ever touches its own rows, so
// the layers need no block barrier.  Rows past N are zero-filled by the
// copy and never written; input widths that are not a multiple of 4 (31 in
// the Instant-NGP color head) are copied 4 bytes at a time, and columns past
// d_in are masked in the product, not padded in device memory.  The grid is
// as many blocks as fit on the card at once (the occupancy calculator,
// given the block's shared memory: three blocks of 4 warps an SM for mlp2,
// two for mlp3; asked once per device and size), or fewer when the tiles
// run out first.
#include <mutex>
#include <vector>

#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int kHMax = 64;
constexpr int kWarps = 4;           // warps per block
constexpr int kTile = 16;           // points per warp tile

// Copy `count` floats from global to shared memory with the whole block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

// The layers of an NL-layer MLP: weight k is (dims[k] x dims[k + 1]),
// row-major, bias k has dims[k + 1] entries.
template <int NL>
struct Chain {
    const float* w[NL];
    const float* b[NL];
    int dims[NL + 1];
};

// Shared memory of a block, in floats: the packed weights, the biases
// (each rounded up to 4 floats, keeping 16-byte alignment), then per warp
// two input tiles and one hidden tile.
template <int NL>
struct Layout {
    int ld_x, ld_h;
    size_t w[NL], b[NL], warps, per_warp, floats;

    __host__ __device__ explicit Layout(const int (&dims)[NL + 1]) {
        int h = 0;
#pragma unroll
        for (int k = 1; k < NL; ++k) h = dims[k] > h ? dims[k] : h;
        ld_x = mlp_tile::act_ld(dims[0]);
        ld_h = mlp_tile::act_ld(h);
        size_t at = 0;
#pragma unroll
        for (int k = 0; k < NL; ++k) {
            w[k] = at;
            at += mlp_tile::Packed::floats(dims[k], dims[k + 1]);
        }
#pragma unroll
        for (int k = 0; k < NL; ++k) {
            b[k] = at;
            at += (dims[k + 1] + 3) / 4 * 4;
        }
        warps = at;
        per_warp = static_cast<size_t>(kTile) * (2 * ld_x + ld_h);
        floats = at + kWarps * per_warp;
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

// A packed weight (mlp_tile::Packed) read at p + k0 * k_stride + c0 * 16 +
// lane * 4: the same address as Packed::b_frag for k0 and c0 multiples of 8,
// without its shifts.  Through Packed::b_frag the layer loops spend a shift
// and a multiply-add more on each fragment's address and hold more
// registers, which costs mlp3 a few percent on an H100 (the same bytes out).
struct Weights {
    const float* p;
    int k_stride;

    Weights() = default;
    __device__ explicit Weights(const mlp_tile::Packed& w) : p(w.p), k_stride(w.n_tiles * 16) {}
    __device__ __forceinline__ void b_frag(int k0, int c0, int g, int t, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) const {
        const float4 v = *reinterpret_cast<const float4*>(p + k0 * k_stride + c0 * 16 +
                                                          (g * 4 + t) * 4);
        hi[0] = __float_as_uint(v.x);
        hi[1] = __float_as_uint(v.y);
        lo[0] = __float_as_uint(v.z);
        lo[1] = __float_as_uint(v.w);
    }
};

template <int NL, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
mlp_kernel(const float* __restrict__ x, const Chain<NL> chain, float* __restrict__ out,
           int n) {
    using mlp_tile::Strided;
    extern __shared__ __align__(16) float smem[];
    const Layout<NL> lay(chain.dims);
    Weights W[NL];
    const float* sb[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k)
        W[k] = Weights(
            mlp_tile::pack(smem + lay.w[k], chain.w[k], chain.dims[k], chain.dims[k + 1]));
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        stage(smem + lay.b[k], chain.b[k], chain.dims[k + 1]);
        sb[k] = smem + lay.b[k];
    }
    const int warp = threadIdx.x >> 5;
    float* xbuf = smem + lay.warps + warp * lay.per_warp;
    float* hid = xbuf + 2 * kTile * lay.ld_x;
    const int ld_x = lay.ld_x, ld_h = lay.ld_h;
    const int d_in = chain.dims[0], d_out = chain.dims[NL];
    __syncthreads();

    const int n_tiles = (n + kTile - 1) / kTile;
    const int stride = gridDim.x * kWarps;
    int tile = blockIdx.x * kWarps + warp;
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
#pragma unroll
        for (int k = 0; k < NL; ++k) {
            const float* bias = sb[k];
            const int k_in = chain.dims[k];
            const Strided<> a = k == 0 ? Strided<>{xs, ld_x, 1, kTile, d_in}
                                       : Strided<>{hid, ld_h, 1, kTile, k_in};
            if (k < NL - 1) {
                // a hidden layer after the first runs in place over `hid`, so
                // one unit covers all its columns (8 tiles); mlp2's only hidden
                // layer reads the input tile and takes units of 4 tiles, which
                // keeps its registers near half of mlp3's and fits more warps
                // an SM
                constexpr int NG = NL == 2 ? 4 : 8;
                mlp_tile::gemm<NG>(a, W[k], kTile, chain.dims[k + 1], k_in,
                                  [&](int r, int c, float v) {
                                      hid[r * ld_h + c] = fmaxf(v + bias[c], 0.0f); },
                                  0, 1);
            } else {
                mlp_tile::gemm<2>(a, W[k], kTile, d_out, k_in,
                                  [&](int r, int c, float v) {
                                      if (row0 + r < n)
                                          out[static_cast<size_t>(row0 + r) * d_out + c] =
                                              v + bias[c];
                                  },
                                  0, 1);
            }
            __syncwarp();          // the next layer, or the next tile, rewrites `hid`
        }
    }
    mlp_tile::wait<0>();
}

// How many blocks of mlp_kernel<NL, VEC> with `smem` bytes of shared memory
// `device` holds at once (the occupancy calculator), 0 if none fits.  The
// first launch at a (device, size) asks the runtime and allows the kernel
// that much shared memory; later ones read the answer back, so a launch in
// steady state makes no runtime call but the launch itself.
template <int NL, bool VEC>
int resident_blocks(size_t smem, int device) {
    struct Seen { int device; size_t smem; int blocks; };
    static std::mutex mu;
    static std::vector<Seen> seen;
    const std::lock_guard<std::mutex> lock(mu);
    size_t allowed = 0;    // the most this device was allowed so far
    for (const Seen& s : seen) {
        if (s.device != device) continue;
        if (s.smem == smem) return s.blocks;
        allowed = s.smem > allowed ? s.smem : allowed;
    }
    const auto kernel = mlp_kernel<NL, VEC>;
    if (smem > allowed &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
        return 0;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem) !=
            cudaSuccess)
        return 0;
    seen.push_back({device, smem, per_sm * sms});
    return per_sm * sms;
}

// Launch the persistent kernel: one block per free slot on the card, or
// fewer when the tiles run out first.
template <int NL>
int launch(const float* x, const Chain<NL>& chain, float* out, int n, void* stream) {
    const size_t smem = sizeof(float) * Layout<NL>(chain.dims).floats;
    const bool vec = chain.dims[0] % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    int device = 0;
    cudaGetDevice(&device);
    const int slots = vec ? resident_blocks<NL, true>(smem, device)
                          : resident_blocks<NL, false>(smem, device);
    if (slots < 1) {
        const cudaError_t err = cudaGetLastError();
        return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
    const int tiles = (n + kTile - 1) / kTile;
    const int wanted = (tiles + kWarps - 1) / kWarps;
    const int grid = wanted < slots ? wanted : slots;
    const auto kernel = vec ? mlp_kernel<NL, true> : mlp_kernel<NL, false>;
    kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(x, chain, out, n);
    return static_cast<int>(cudaGetLastError());
}

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
    const Chain<2> chain{{w1, w2}, {b1, b2}, {d_in, hidden, d_out}};
    return launch<2>(x, chain, out, n, stream);
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
    const Chain<3> chain{{w1, w2, w3}, {b1, b2, b3}, {d_in, h1, h2, d_out}};
    return launch<3>(x, chain, out, n, stream);
}
