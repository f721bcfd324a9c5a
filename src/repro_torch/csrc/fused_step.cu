// One-op training step of a decomposed field: both grids' multires encode
// and both MLP heads, forward and backward.
//
// Replaces: src/repro/kernels/fused_step/kernel.py:122 fused_step_pallas
// (body _fused_step_kernel :89, dedup encode _dedup_encode_block :55) and
// src/repro/kernels/fused_step/kernel.py:266 fused_step_bwd_pallas (body
// _fused_step_bwd_kernel :171, in-block BUM commit :245-257).
//
// What bounds it on the H100.  Forward: the f32 FMA rate -- each point does
// ~9,800 multiply-adds in the two MLP heads against ~2 KB of gathered table
// rows, most of them served by the 50 MB L2 that holds both table sets
// (40 MiB).  The forward's arithmetic is plain f32 FMA on the CUDA cores.
// Backward: the two heads recomputed, their data gradients and their weight
// gradients, about three times the forward's multiply-adds, on the tensor
// cores in split TF32 (three TF32 products each, at 495 TFLOP/s); the
// encode's f32 work on the CUDA cores; and the table-gradient streams it
// writes (16 bytes per corner and grid).
//
// Forward design.  The TPU kernel ran a (block, level) grid with the level
// axis innermost, holding one level table per step in VMEM and the block's
// (B, L*F) feature tiles in revisited output blocks, with an MLP epilogue at
// the last level.  A level table (2 MiB) does not fit in shared memory, so
// here one block of kFwdPoints points loops over the L levels itself: each
// thread owns one point, gathers its 8 corners per level from both grids
// through __ldg, and writes its features into the block's shared-memory
// tiles; then the MLP epilogue runs from shared memory with every weight
// resident there too, so the features never reach device memory.  The TPU's
// dedup-as-matmul (sorted in-block addresses, W (B, B*8) @ rows) was a way to
// use the MXU; a straight gather computes the same function.  Sentinel rows
// (x < 0) read row 0 at weight 0.
//
// Backward design: deterministic, two passes, no float atomics.  The
// reference writes its backward as block-level matrix products (hd @ w1d,
// h1d.T @ g_d, ...); so does this kernel, on the tensor cores.
//   Pass 1 (fused_step_bwd_kernel): one tile of kBwdPoints Morton-ordered
//   points per block, every thread of the block on it.  Threads take
//   (point, level) items to gather both grids' features into the tile; then
//   every product of both heads runs through mlp_tile.cuh's split-TF32
//   tensor-core routine on tiles in shared memory -- the recompute (z = x W
//   + b), the data gradients (g W^T times relu'(z), down to the features
//   and d_sh) and the weight gradients (x^T g, summed over the tile's
//   points in a fixed order), the last written as the block's row of
//   partials (n_blocks, P); bias gradients are column sums in point order.
//   Weights and activation tiles (~100 KB at FieldConfig()) leave room for
//   two blocks on an SM.  Then the block writes each corner's table update
//   as it is: address l*T + a and the product w_c * g_feat rounded as the
//   plain version rounds it (__fmul_rn), at stream position (l * n_pad + i)
//   * 8 + c -- level-major, then point, then corner, the plain version's
//   own stream order; points past N write the spill address L*T, value 0.
//   Pass 2: fused_step_reduce sums the partials over blocks in block order;
//   the wrapper stable-sorts each grid's stream by address and commits it
//   with the bum_scatter kernel, which sums each run in stream order and
//   drops the spill entries -- each table row summed in exactly the plain
//   version's order.
// A grid whose table is frozen gets no stream at all (null pointers), as
// the reference dead-code-eliminates its commit.  Corner weights are (w_x *
// w_y) * w_z with the scaled coordinate rounded first, as in the plain
// version.
#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kFwdPoints = 128;     // points (= threads) per forward block
constexpr int kBwdPoints = 32;      // points per backward block (one tile)
constexpr int kBwdThreads = 256;    // threads per backward block
constexpr int kBwdGroup = 2;        // 8-column tiles per warp unit of a product
constexpr int kGatherRows = 32;     // table-row floats a thread gathers at once, per grid
constexpr int kMaxOutD = 16;        // density head outputs (1 + geo)
constexpr int kMaxOutC = 4;         // color head outputs (3)
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use

struct Geom {
    int res[kMaxLevels];
    int dense_d[kMaxLevels];
    int dense_c[kMaxLevels];
};

// Widths, in the order the host passes them.
struct Dims {
    int n, levels, f, sh, table_d, table_c, hid_d, out_d, hid_c1, hid_c2, out_c;
    __host__ __device__ int feat() const { return levels * f; }
    __host__ __device__ int cin() const { return levels * f + sh; }
    __host__ __device__ int n_params() const {
        return feat() * hid_d + hid_d + hid_d * out_d + out_d + cin() * hid_c1 + hid_c1 +
               hid_c1 * hid_c2 + hid_c2 + hid_c2 * out_c + out_c;
    }
};

struct Mlps {
    const float *w1d, *b1d, *w2d, *b2d, *w1c, *b1c, *w2c, *b2c, *w3c, *b3c;
};

// Row stride of a per-point shared-memory row: odd, so that the threads of a
// warp, each reading element k of its own row, hit 32 different banks.
__host__ __device__ inline int odd(int w) { return w | 1; }

// Every MLP weight and bias staged into shared memory, in the order of the
// partials row: density w1 b1 w2 b2, color w1 b1 w2 b2 w3 b3.
struct SmemWeights {
    float *w1d, *b1d, *w2d, *b2d, *w1c, *b1c, *w2c, *b2c, *w3c, *b3c;
};

__device__ SmemWeights stage_weights(float* base, const Mlps& m, const Dims& d) {
    SmemWeights s;
    const int sizes[10] = {d.feat() * d.hid_d, d.hid_d, d.hid_d * d.out_d, d.out_d,
                           d.cin() * d.hid_c1, d.hid_c1, d.hid_c1 * d.hid_c2, d.hid_c2,
                           d.hid_c2 * d.out_c, d.out_c};
    const float* src[10] = {m.w1d, m.b1d, m.w2d, m.b2d, m.w1c, m.b1c, m.w2c, m.b2c,
                            m.w3c, m.b3c};
    float** dst[10] = {&s.w1d, &s.b1d, &s.w2d, &s.b2d, &s.w1c, &s.b1c, &s.w2c, &s.b2c,
                       &s.w3c, &s.b3c};
    float* p = base;
    for (int a = 0; a < 10; ++a) {
        *dst[a] = p;
        for (int k = threadIdx.x; k < sizes[a]; k += blockDim.x) p[k] = src[a][k];
        p += sizes[a];
    }
    return s;
}

// ---- corner geometry (the plain version's, exactly) ----

struct LevelPoint {
    int ix, iy, iz;
    float fx, fy, fz;
    long long stride;
    bool valid;
};

__device__ __forceinline__ LevelPoint level_point(float px, float py, float pz, int res) {
    const float rf = static_cast<float>(res);
    const float sx = __fmul_rn(px, rf), sy = __fmul_rn(py, rf), sz = __fmul_rn(pz, rf);
    const float bx = floorf(sx), by = floorf(sy), bz = floorf(sz);
    LevelPoint q;
    q.ix = static_cast<int>(bx);
    q.iy = static_cast<int>(by);
    q.iz = static_cast<int>(bz);
    q.fx = __fsub_rn(sx, bx);
    q.fy = __fsub_rn(sy, by);
    q.fz = __fsub_rn(sz, bz);
    q.stride = static_cast<long long>(res) + 1;
    q.valid = px >= 0.0f;
    return q;
}

__device__ __forceinline__ long long corner_index(const LevelPoint& q, int c, bool dense,
                                                  int table_size) {
    if (!q.valid) return 0;
    const int cx = q.ix + (c & 1), cy = q.iy + ((c >> 1) & 1), cz = q.iz + ((c >> 2) & 1);
    if (dense) {
        long long i = cx + cy * q.stride + cz * q.stride * q.stride;
        return i < 0 ? 0 : (i > table_size - 1 ? table_size - 1 : i);
    }
    const uint32_t h = static_cast<uint32_t>(cx) * 1u
                     ^ static_cast<uint32_t>(cy) * 2654435761u
                     ^ static_cast<uint32_t>(cz) * 805459861u;
    return static_cast<long long>(h & static_cast<uint32_t>(table_size - 1));
}

__device__ __forceinline__ float corner_weight(const LevelPoint& q, int c) {
    if (!q.valid) return 0.0f;
    const float wx = (c & 1) ? q.fx : __fsub_rn(1.0f, q.fx);
    const float wy = ((c >> 1) & 1) ? q.fy : __fsub_rn(1.0f, q.fy);
    const float wz = ((c >> 2) & 1) ? q.fz : __fsub_rn(1.0f, q.fz);
    return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Both grids' features of point i into its shared-memory rows.
template <int F>
__device__ void encode_point(const float* __restrict__ points, int i,
                             const float* __restrict__ td, const float* __restrict__ tc,
                             const Geom& g, const Dims& d, float* row_d, float* row_c) {
    const float px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
    for (int l = 0; l < d.levels; ++l) {
        const LevelPoint q = level_point(px, py, pz, g.res[l]);
        const float* tbl_d = td + static_cast<size_t>(l) * d.table_d * F;
        const float* tbl_c = tc + static_cast<size_t>(l) * d.table_c * F;
        float ad[F], ac[F];
#pragma unroll
        for (int f = 0; f < F; ++f) ad[f] = ac[f] = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float w = corner_weight(q, c);
            const long long id = corner_index(q, c, g.dense_d[l] != 0, d.table_d);
            const long long ic = corner_index(q, c, g.dense_c[l] != 0, d.table_c);
#pragma unroll
            for (int f = 0; f < F; ++f) {
                ad[f] += w * __ldg(tbl_d + id * F + f);
                ac[f] += w * __ldg(tbl_c + ic * F + f);
            }
        }
#pragma unroll
        for (int f = 0; f < F; ++f) {
            row_d[l * F + f] = ad[f];
            row_c[l * F + f] = ac[f];
        }
    }
}

// d relu(z) / dz with the reference's maximum(z, 0): 1/2 at the tie.
__device__ __forceinline__ float relu_grad(float z) {
    return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
}

// ---- forward ----

__host__ __device__ inline size_t fwd_smem_floats(const Dims& d) {
    return static_cast<size_t>(d.n_params()) +
           static_cast<size_t>(kFwdPoints) * (odd(d.feat()) + odd(d.cin()) + odd(d.hid_c1));
}

template <int F>
__global__ void __launch_bounds__(kFwdPoints)
fused_step_fwd_kernel(const float* __restrict__ points, const float* __restrict__ sh,
                      const float* __restrict__ td, const float* __restrict__ tc,
                      const Mlps m, const Geom g, const Dims d,
                      float* __restrict__ out_d, float* __restrict__ out_c) {
    extern __shared__ __align__(16) float smem[];
    const SmemWeights w = stage_weights(smem, m, d);
    const int ld_d = odd(d.feat()), ld_c = odd(d.cin()), ld_h = odd(d.hid_c1);
    const int p = threadIdx.x;
    float* xd = smem + d.n_params() + p * ld_d;
    float* xc = smem + d.n_params() + kFwdPoints * ld_d + p * ld_c;
    float* h1 = smem + d.n_params() + kFwdPoints * (ld_d + ld_c) + p * ld_h;
    __syncthreads();

    const int i = blockIdx.x * kFwdPoints + p;
    if (i >= d.n) return;
    const int feat = d.feat(), cin = d.cin();
    encode_point<F>(points, i, td, tc, g, d, xd, xc);
    for (int k = 0; k < d.sh; ++k) xc[feat + k] = sh[static_cast<size_t>(i) * d.sh + k];

    // density head: relu(x W1 + b1) W2 + b2
    float acc[kMaxOutD];
#pragma unroll
    for (int o = 0; o < kMaxOutD; ++o) acc[o] = 0.0f;
    for (int j = 0; j < d.hid_d; ++j) {
        float s = 0.0f;
        for (int k = 0; k < feat; ++k) s += xd[k] * w.w1d[k * d.hid_d + j];
        const float h = fmaxf(s + w.b1d[j], 0.0f);
#pragma unroll
        for (int o = 0; o < kMaxOutD; ++o)
            if (o < d.out_d) acc[o] += h * w.w2d[j * d.out_d + o];
    }
#pragma unroll
    for (int o = 0; o < kMaxOutD; ++o)
        if (o < d.out_d) out_d[static_cast<size_t>(i) * d.out_d + o] = acc[o] + w.b2d[o];

    // color head on [color features, sh]: two hidden ReLU layers, linear head
    for (int j = 0; j < d.hid_c1; ++j) {
        float s = 0.0f;
        for (int k = 0; k < cin; ++k) s += xc[k] * w.w1c[k * d.hid_c1 + j];
        h1[j] = fmaxf(s + w.b1c[j], 0.0f);
    }
    float accc[kMaxOutC];
#pragma unroll
    for (int o = 0; o < kMaxOutC; ++o) accc[o] = 0.0f;
    for (int j = 0; j < d.hid_c2; ++j) {
        float s = 0.0f;
        for (int k = 0; k < d.hid_c1; ++k) s += h1[k] * w.w2c[k * d.hid_c2 + j];
        const float a2 = fmaxf(s + w.b2c[j], 0.0f);
#pragma unroll
        for (int o = 0; o < kMaxOutC; ++o)
            if (o < d.out_c) accc[o] += a2 * w.w3c[j * d.out_c + o];
    }
#pragma unroll
    for (int o = 0; o < kMaxOutC; ++o)
        if (o < d.out_c) out_c[static_cast<size_t>(i) * d.out_c + o] = accc[o] + w.b3c[o];
}

// ---- backward, pass 1 ----

// Shared-memory carve-up of the backward block (floats): every MLP weight
// with its rows padded for conflict-free B-fragment reads, the biases, then
// the tile's activation buffers, each kBwdPoints rows.  h0 / h1 / h2 hold
// the hidden layers' pre-activations and gradients, reused from the density
// head to the color head.
struct BwdLayout {
    int ld_w1d, ld_w2d, ld_w1c, ld_w2c, ld_w3c, ld_f, ld_c, ld_gd, ld_gc, ld_h;
    size_t w1d, b1d, w2d, b2d, w1c, b1c, w2c, b2c, w3c, b3c;
    size_t xd, xc, gd, gc, ghd, ghc, h0, h1, h2, floats;

    __host__ __device__ explicit BwdLayout(const Dims& d) {
        using mlp_tile::act_ld;
        using mlp_tile::weight_ld;
        ld_w1d = weight_ld(d.hid_d);
        ld_w2d = weight_ld(d.out_d);
        ld_w1c = weight_ld(d.hid_c1);
        ld_w2c = weight_ld(d.hid_c2);
        ld_w3c = weight_ld(d.out_c);
        ld_f = act_ld(d.feat());
        ld_c = act_ld(d.cin());
        ld_gd = act_ld(d.out_d);
        ld_gc = act_ld(d.out_c);
        const int hid = d.hid_d > d.hid_c1 ? d.hid_d : d.hid_c1;
        ld_h = act_ld(hid > d.hid_c2 ? hid : d.hid_c2);
        size_t at = 0;
        w1d = at; at += static_cast<size_t>(d.feat()) * ld_w1d;
        b1d = at; at += d.hid_d;
        w2d = at; at += static_cast<size_t>(d.hid_d) * ld_w2d;
        b2d = at; at += d.out_d;
        w1c = at; at += static_cast<size_t>(d.cin()) * ld_w1c;
        b1c = at; at += d.hid_c1;
        w2c = at; at += static_cast<size_t>(d.hid_c1) * ld_w2c;
        b2c = at; at += d.hid_c2;
        w3c = at; at += static_cast<size_t>(d.hid_c2) * ld_w3c;
        b3c = at; at += d.out_c;
        xd = at;  at += kBwdPoints * ld_f;      // density features
        xc = at;  at += kBwdPoints * ld_c;      // [color features, sh]
        gd = at;  at += kBwdPoints * ld_gd;     // cotangent of the density head
        gc = at;  at += kBwdPoints * ld_gc;     // cotangent of the color head
        ghd = at; at += kBwdPoints * ld_f;      // gradient of the density features
        ghc = at; at += kBwdPoints * ld_f;      // gradient of the color features
        h0 = at;  at += kBwdPoints * ld_h;
        h1 = at;  at += kBwdPoints * ld_h;
        h2 = at;  at += kBwdPoints * ld_h;
        floats = at;
    }
    __host__ __device__ size_t bytes() const { return floats * sizeof(float); }
};

// W (k x n, device memory) into shared memory with row stride ld, by
// asynchronous copies that run on while the block gathers its features.
__device__ void stage_rows(float* dst, const float* __restrict__ w, int k, int n, int ld) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
    for (int r = warp; r < k; r += n_warps)
        for (int c = lane; c < n; c += 32)
            mlp_tile::cp_async<4>(dst + r * ld + c, w + r * n + c, true);
}

__device__ void stage_flat(float* dst, const float* __restrict__ src, int count) {
    for (int e = threadIdx.x; e < count; e += blockDim.x)
        mlp_tile::cp_async<4>(dst + e, src + e, true);
}

// One table row of F floats through the read-only cache, in as few loads as
// its width allows.
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ row, float (&v)[F]) {
    if constexpr (F % 4 == 0) {
#pragma unroll
        for (int f = 0; f < F; f += 4) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(row + f));
            v[f] = x.x;
            v[f + 1] = x.y;
            v[f + 2] = x.z;
            v[f + 3] = x.w;
        }
    } else if constexpr (F == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(row));
        v[0] = x.x;
        v[1] = x.y;
    } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __ldg(row + f);
    }
}

// Column sums of a kBwdPoints-row tile, each summed over the points in order.
__device__ void column_sums(const float* tile, int ld, int n, float* __restrict__ out) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float s = 0.0f;
        for (int r = 0; r < kBwdPoints; ++r) s = __fadd_rn(s, tile[r * ld + c]);
        out[c] = s;
    }
}

template <int F>
__global__ void __launch_bounds__(kBwdThreads)
fused_step_bwd_kernel(const float* __restrict__ points, const float* __restrict__ sh,
                      const float* __restrict__ g_d, const float* __restrict__ g_c,
                      const float* __restrict__ td, const float* __restrict__ tc,
                      const Mlps m, const Geom g, const Dims d,
                      float* __restrict__ partials, float* __restrict__ d_sh,
                      long long* __restrict__ addr_d, float* __restrict__ val_d,
                      long long* __restrict__ addr_c, float* __restrict__ val_c) {
    using mlp_tile::Strided;
    extern __shared__ __align__(16) float smem[];
    const BwdLayout lay(d);
    const int feat = d.feat(), cin = d.cin(), levels = d.levels;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int base = blockIdx.x * kBwdPoints;
    constexpr int P = kBwdPoints;

    float* w1d = smem + lay.w1d; float* b1d = smem + lay.b1d;
    float* w2d = smem + lay.w2d; float* b2d = smem + lay.b2d;
    float* w1c = smem + lay.w1c; float* b1c = smem + lay.b1c;
    float* w2c = smem + lay.w2c; float* b2c = smem + lay.b2c;
    float* w3c = smem + lay.w3c; float* b3c = smem + lay.b3c;
    float* xd = smem + lay.xd;   float* xc = smem + lay.xc;
    float* gd = smem + lay.gd;   float* gc = smem + lay.gc;
    float* ghd = smem + lay.ghd; float* ghc = smem + lay.ghc;
    float* h0 = smem + lay.h0;   float* h1 = smem + lay.h1;   float* h2 = smem + lay.h2;

    stage_rows(w1d, m.w1d, feat, d.hid_d, lay.ld_w1d);
    stage_rows(w2d, m.w2d, d.hid_d, d.out_d, lay.ld_w2d);
    stage_rows(w1c, m.w1c, cin, d.hid_c1, lay.ld_w1c);
    stage_rows(w2c, m.w2c, d.hid_c1, d.hid_c2, lay.ld_w2c);
    stage_rows(w3c, m.w3c, d.hid_c2, d.out_c, lay.ld_w3c);
    stage_flat(b1d, m.b1d, d.hid_d);
    stage_flat(b2d, m.b2d, d.out_d);
    stage_flat(b1c, m.b1c, d.hid_c1);
    stage_flat(b2c, m.b2c, d.hid_c2);
    stage_flat(b3c, m.b3c, d.out_c);
    mlp_tile::commit();

    // recompute both grids' features, `items` (point, level) items per
    // thread at a time so that all their table reads are in flight together
    // (the reads, mostly from device memory, bound this phase); points past
    // the end get all-zero rows, which add nothing anywhere
    constexpr int kGatherItems = kGatherRows / (8 * F) > 0 ? kGatherRows / (8 * F) : 1;
    for (int item0 = threadIdx.x; item0 < P * levels; item0 += kGatherItems * blockDim.x) {
        float rows_d[kGatherItems][8][F], rows_c[kGatherItems][8][F], wts[kGatherItems][8];
#pragma unroll
        for (int u = 0; u < kGatherItems; ++u) {
            const int item = item0 + u * blockDim.x;
            const int p = item % P, l = item / P, i = base + p;
            const bool live = item < P * levels && i < d.n;
            const LevelPoint q = live ? level_point(points[3 * i], points[3 * i + 1],
                                                    points[3 * i + 2], g.res[l])
                                      : level_point(-1.0f, 0.0f, 0.0f, 1);
            const float* tbl_d = td + static_cast<size_t>(live ? l : 0) * d.table_d * F;
            const float* tbl_c = tc + static_cast<size_t>(live ? l : 0) * d.table_c * F;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                wts[u][c] = corner_weight(q, c);
                const long long id = corner_index(q, c, live && g.dense_d[l] != 0, d.table_d);
                const long long ic = corner_index(q, c, live && g.dense_c[l] != 0, d.table_c);
                load_row<F>(tbl_d + id * F, rows_d[u][c]);
                load_row<F>(tbl_c + ic * F, rows_c[u][c]);
            }
        }
#pragma unroll
        for (int u = 0; u < kGatherItems; ++u) {
            const int item = item0 + u * blockDim.x;
            if (item >= P * levels) continue;
            const int p = item % P, l = item / P;
            float ad[F], ac[F];
#pragma unroll
            for (int f = 0; f < F; ++f) ad[f] = ac[f] = 0.0f;
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    ad[f] += wts[u][c] * rows_d[u][c][f];
                    ac[f] += wts[u][c] * rows_c[u][c][f];
                }
#pragma unroll
            for (int f = 0; f < F; ++f) {
                xd[p * lay.ld_f + l * F + f] = ad[f];
                xc[p * lay.ld_c + l * F + f] = ac[f];
            }
        }
    }
    for (int e = threadIdx.x; e < P * d.sh; e += blockDim.x) {
        const int p = e / d.sh, k = e - p * d.sh, i = base + p;
        xc[p * lay.ld_c + feat + k] = i < d.n ? sh[static_cast<size_t>(i) * d.sh + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < P * d.out_d; e += blockDim.x) {
        const int p = e / d.out_d, o = e - p * d.out_d, i = base + p;
        gd[p * lay.ld_gd + o] = i < d.n ? g_d[static_cast<size_t>(i) * d.out_d + o] : 0.0f;
    }
    for (int e = threadIdx.x; e < P * d.out_c; e += blockDim.x) {
        const int p = e / d.out_c, o = e - p * d.out_c, i = base + p;
        gc[p * lay.ld_gc + o] = i < d.n ? g_c[static_cast<size_t>(i) * d.out_c + o] : 0.0f;
    }
    mlp_tile::wait<0>();    // this thread's weight copies have landed
    __syncthreads();

    // operands: X (points x width, row-major tile), X^T, W (x W), W^T (g W^T)
    auto X = [](const float* t, int ld, int cols) { return Strided<>{t, ld, 1, P, cols}; };
    auto XR = [](const float* t, int ld, int cols) {      // relu of a pre-activation tile
        return Strided<true>{t, ld, 1, P, cols}; };
    auto XT = [](const float* t, int ld, int cols) { return Strided<>{t, 1, ld, cols, P}; };
    auto XTR = [](const float* t, int ld, int cols) {
        return Strided<true>{t, 1, ld, cols, P}; };
    auto W = [](const float* w, int ld, int k, int n) { return Strided<>{w, ld, 1, k, n}; };
    auto WT = [](const float* w, int ld, int k, int n) { return Strided<>{w, 1, ld, n, k}; };
    float* row = partials + static_cast<size_t>(blockIdx.x) * d.n_params();
    const int ldh = lay.ld_h;
    // offsets of each parameter in the partials row
    const int o_w1d = 0, o_b1d = o_w1d + feat * d.hid_d, o_w2d = o_b1d + d.hid_d;
    const int o_b2d = o_w2d + d.hid_d * d.out_d, o_w1c = o_b2d + d.out_d;
    const int o_b1c = o_w1c + cin * d.hid_c1, o_w2c = o_b1c + d.hid_c1;
    const int o_b2c = o_w2c + d.hid_c1 * d.hid_c2, o_w3c = o_b2c + d.hid_c2;
    const int o_b3c = o_w3c + d.hid_c2 * d.out_c;

    // density head: z = x W1 + b1 (h0); g_h = (g_d W2^T) relu'(z) (h1)
    mlp_tile::gemm<kBwdGroup>(X(xd, lay.ld_f, feat), W(w1d, lay.ld_w1d, feat, d.hid_d), P,
                              d.hid_d, feat,
                              [&](int r, int c, float v) { h0[r * ldh + c] = v + b1d[c]; },
                              warp, n_warps);
    __syncthreads();
    mlp_tile::gemm<kBwdGroup>(X(gd, lay.ld_gd, d.out_d), WT(w2d, lay.ld_w2d, d.hid_d, d.out_d),
                              P, d.hid_d, d.out_d,
                              [&](int r, int c, float v) {
                                  h1[r * ldh + c] = v * relu_grad(h0[r * ldh + c]); },
                              warp, n_warps);
    __syncthreads();
    // g_x = g_h W1^T; dW1 = x^T g_h; dW2 = relu(z)^T g_d; biases
    mlp_tile::gemm<kBwdGroup>(X(h1, ldh, d.hid_d), WT(w1d, lay.ld_w1d, feat, d.hid_d), P,
                              feat, d.hid_d,
                              [&](int r, int c, float v) { ghd[r * lay.ld_f + c] = v; },
                              warp, n_warps);
    mlp_tile::gemm<kBwdGroup>(XT(xd, lay.ld_f, feat), X(h1, ldh, d.hid_d), feat, d.hid_d, P,
                              [&](int r, int c, float v) { row[o_w1d + r * d.hid_d + c] = v; },
                              warp, n_warps);
    mlp_tile::gemm<kBwdGroup>(XTR(h0, ldh, d.hid_d), X(gd, lay.ld_gd, d.out_d), d.hid_d,
                              d.out_d, P,
                              [&](int r, int c, float v) { row[o_w2d + r * d.out_d + c] = v; },
                              warp, n_warps);
    column_sums(h1, ldh, d.hid_d, row + o_b1d);
    column_sums(gd, lay.ld_gd, d.out_d, row + o_b2d);
    __syncthreads();

    // color head on [color features, sh]: z1 (h0), z2 (h2)
    mlp_tile::gemm<kBwdGroup>(X(xc, lay.ld_c, cin), W(w1c, lay.ld_w1c, cin, d.hid_c1), P,
                              d.hid_c1, cin,
                              [&](int r, int c, float v) { h0[r * ldh + c] = v + b1c[c]; },
                              warp, n_warps);
    __syncthreads();
    mlp_tile::gemm<kBwdGroup>(XR(h0, ldh, d.hid_c1), W(w2c, lay.ld_w2c, d.hid_c1, d.hid_c2), P,
                              d.hid_c2, d.hid_c1,
                              [&](int r, int c, float v) { h2[r * ldh + c] = v + b2c[c]; },
                              warp, n_warps);
    __syncthreads();
    // g_h2 = (g_c W3^T) relu'(z2) (h1); dW3 = relu(z2)^T g_c
    mlp_tile::gemm<kBwdGroup>(X(gc, lay.ld_gc, d.out_c), WT(w3c, lay.ld_w3c, d.hid_c2, d.out_c),
                              P, d.hid_c2, d.out_c,
                              [&](int r, int c, float v) {
                                  h1[r * ldh + c] = v * relu_grad(h2[r * ldh + c]); },
                              warp, n_warps);
    mlp_tile::gemm<kBwdGroup>(XTR(h2, ldh, d.hid_c2), X(gc, lay.ld_gc, d.out_c), d.hid_c2,
                              d.out_c, P,
                              [&](int r, int c, float v) { row[o_w3c + r * d.out_c + c] = v; },
                              warp, n_warps);
    column_sums(gc, lay.ld_gc, d.out_c, row + o_b3c);
    __syncthreads();
    // g_h1 = (g_h2 W2^T) relu'(z1) (h2); dW2 = relu(z1)^T g_h2
    mlp_tile::gemm<kBwdGroup>(X(h1, ldh, d.hid_c2), WT(w2c, lay.ld_w2c, d.hid_c1, d.hid_c2), P,
                              d.hid_c1, d.hid_c2,
                              [&](int r, int c, float v) {
                                  h2[r * ldh + c] = v * relu_grad(h0[r * ldh + c]); },
                              warp, n_warps);
    mlp_tile::gemm<kBwdGroup>(XTR(h0, ldh, d.hid_c1), X(h1, ldh, d.hid_c2), d.hid_c1,
                              d.hid_c2, P,
                              [&](int r, int c, float v) { row[o_w2c + r * d.hid_c2 + c] = v; },
                              warp, n_warps);
    column_sums(h1, ldh, d.hid_c2, row + o_b2c);
    __syncthreads();
    // g_cin = g_h1 W1^T -> the color features' gradient and d_sh; dW1 = cin^T g_h1
    mlp_tile::gemm<kBwdGroup>(X(h2, ldh, d.hid_c1), WT(w1c, lay.ld_w1c, cin, d.hid_c1), P, cin,
                              d.hid_c1,
                              [&](int r, int c, float v) {
                                  if (c < feat) {
                                      ghc[r * lay.ld_f + c] = v;
                                  } else if (base + r < d.n) {
                                      d_sh[static_cast<size_t>(base + r) * d.sh + (c - feat)] = v;
                                  }
                              },
                              warp, n_warps);
    mlp_tile::gemm<kBwdGroup>(XT(xc, lay.ld_c, cin), X(h2, ldh, d.hid_c1), cin, d.hid_c1, P,
                              [&](int r, int c, float v) { row[o_w1c + r * d.hid_c1 + c] = v; },
                              warp, n_warps);
    column_sums(h2, ldh, d.hid_c1, row + o_b1c);

    // table gradients: each corner's update as it is, in the plain stream's
    // order (level, point, corner); consecutive threads write consecutive
    // entries
    if (addr_d == nullptr && addr_c == nullptr) return;
    __syncthreads();
    const size_t n_pad = static_cast<size_t>(gridDim.x) * P;
    for (int e = threadIdx.x; e < P * 8 * levels; e += blockDim.x) {
        const int c = e & 7, p = (e >> 3) % P, l = (e >> 3) / P, i = base + p;
        const size_t pos = (static_cast<size_t>(l) * n_pad + base + p) * 8 + c;
        if (i < d.n) {
            const LevelPoint q = level_point(points[3 * i], points[3 * i + 1], points[3 * i + 2],
                                             g.res[l]);
            const float w = corner_weight(q, c);
            if (addr_d != nullptr) {
                addr_d[pos] = static_cast<long long>(l) * d.table_d +
                              corner_index(q, c, g.dense_d[l] != 0, d.table_d);
#pragma unroll
                for (int f = 0; f < F; ++f)
                    val_d[pos * F + f] = __fmul_rn(w, ghd[p * lay.ld_f + l * F + f]);
            }
            if (addr_c != nullptr) {
                addr_c[pos] = static_cast<long long>(l) * d.table_c +
                              corner_index(q, c, g.dense_c[l] != 0, d.table_c);
#pragma unroll
                for (int f = 0; f < F; ++f)
                    val_c[pos * F + f] = __fmul_rn(w, ghc[p * lay.ld_f + l * F + f]);
            }
        } else {
            // past the end: the spill address L*T, dropped by the commit
            if (addr_d != nullptr) {
                addr_d[pos] = static_cast<long long>(levels) * d.table_d;
#pragma unroll
                for (int f = 0; f < F; ++f) val_d[pos * F + f] = 0.0f;
            }
            if (addr_c != nullptr) {
                addr_c[pos] = static_cast<long long>(levels) * d.table_c;
#pragma unroll
                for (int f = 0; f < F; ++f) val_c[pos * F + f] = 0.0f;
            }
        }
    }
}

// ---- backward, pass 2: the partials summed over blocks in block order ----

// Each block sums kReduceCols parameters: its warps stage kReduceRows rows
// of them at a time in shared memory (asynchronous copies, all in flight
// together), then lane c of warp 0 adds its column's rows one after another.
// Every parameter is summed over the blocks in block order, as a plain loop
// would sum it, while the loads overlap.
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 256;
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
fused_step_reduce_kernel(const float* __restrict__ partials, int n_blocks, int n_params,
                         float* __restrict__ out) {
    __shared__ float tile[kReduceRows][kReduceCols + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x * kReduceCols + lane;
    const bool in = e < n_params;
    float s = 0.0f;
    for (int r0 = 0; r0 < n_blocks; r0 += kReduceRows) {
        const int rows = n_blocks - r0 < kReduceRows ? n_blocks - r0 : kReduceRows;
        for (int r = warp; r < rows; r += kReduceThreads / 32)
            mlp_tile::cp_async<4>(&tile[r][lane],
                                  partials + static_cast<size_t>(r0 + r) * n_params +
                                      (in ? e : 0),
                                  in);
        mlp_tile::commit();
        mlp_tile::wait<0>();
        __syncthreads();
        if (warp == 0)
            for (int r = 0; r < rows; ++r) s = __fadd_rn(s, tile[r][lane]);
        __syncthreads();
    }
    if (warp == 0 && in) out[e] = s;
}

bool read_args(const int* dims, const int* res, const int* dense_d, const int* dense_c,
               const void* const* mlp, Dims* d, Geom* g, Mlps* m) {
    *d = Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
              dims[6], dims[7], dims[8], dims[9], dims[10]};
    if (d->n < 0 || d->levels < 1 || d->levels > kMaxLevels || d->sh < 0) return false;
    if (d->table_d < 1 || (d->table_d & (d->table_d - 1)) != 0) return false;
    if (d->table_c < 1 || (d->table_c & (d->table_c - 1)) != 0) return false;
    if (d->hid_d < 1 || d->hid_c1 < 1 || d->hid_c2 < 1) return false;
    if (d->out_d < 1 || d->out_d > kMaxOutD || d->out_c < 1 || d->out_c > kMaxOutC) return false;
    for (int l = 0; l < d->levels; ++l) {
        g->res[l] = res[l];
        g->dense_d[l] = dense_d[l];
        g->dense_c[l] = dense_c[l];
    }
    const float* const* w = reinterpret_cast<const float* const*>(mlp);
    *m = Mlps{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
    return true;
}

template <int F>
int launch_fwd(const float* points, const float* sh, const float* td, const float* tc,
               const Mlps& m, const Geom& g, const Dims& d, float* out_d, float* out_c,
               cudaStream_t s) {
    const size_t bytes = fwd_smem_floats(d) * sizeof(float);
    if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(fused_step_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const int blocks = (d.n + kFwdPoints - 1) / kFwdPoints;
    fused_step_fwd_kernel<F><<<blocks, kFwdPoints, bytes, s>>>(points, sh, td, tc, m, g, d,
                                                              out_d, out_c);
    return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_bwd(const float* points, const float* sh, const float* g_d, const float* g_c,
               const float* td, const float* tc, const Mlps& m, const Geom& g, const Dims& d,
               float* partials, float* d_sh, long long* addr_d, float* val_d,
               long long* addr_c, float* val_c, float* grad_mlp, cudaStream_t s) {
    const BwdLayout lay(d);
    const size_t bytes = lay.bytes();
    if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(fused_step_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const int blocks = (d.n + kBwdPoints - 1) / kBwdPoints;
    fused_step_bwd_kernel<F><<<blocks, kBwdThreads, bytes, s>>>(
        points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh, addr_d, val_d, addr_c, val_c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_step_reduce_kernel<<<(d.n_params() + kReduceCols - 1) / kReduceCols,
                               kReduceThreads, 0, s>>>(partials, blocks, d.n_params(),
                                                       grad_mlp);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dims (11 host ints): n, levels, n_features, sh_dim, T_density, T_color,
// density hidden, density outputs, color hidden 1, color hidden 2, color
// outputs.  mlp: host array of the 10 device pointers w1d b1d w2d b2d w1c b1c
// w2c b2c w3c b3c ((d_in, d_out) layout).  res / dense_d / dense_c: host
// arrays of `levels` ints.  points (n, 3), sh (n, sh_dim), tables (L, T, F),
// out_d (n, density outputs), out_c (n, color outputs): f32, contiguous.
extern "C" int fused_step_forward(const float* points, const float* sh, const float* td,
                                  const float* tc, const void* const* mlp, const int* res,
                                  const int* dense_d, const int* dense_c, const int* dims,
                                  float* out_d, float* out_c, void* stream) {
    Dims d;
    Geom g;
    Mlps m;
    if (!read_args(dims, res, dense_d, dense_c, mlp, &d, &g, &m))
        return static_cast<int>(cudaErrorInvalidValue);
    if (d.n == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d.f) {
        case 1: return launch_fwd<1>(points, sh, td, tc, m, g, d, out_d, out_c, s);
        case 2: return launch_fwd<2>(points, sh, td, tc, m, g, d, out_d, out_c, s);
        case 4: return launch_fwd<4>(points, sh, td, tc, m, g, d, out_d, out_c, s);
        case 8: return launch_fwd<8>(points, sh, td, tc, m, g, d, out_d, out_c, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// As the forward, plus: g_d (n, density outputs) and g_c (n, color outputs)
// the cotangents; partials (n_blocks, P) scratch with n_blocks = ceil(n / 32)
// and P the MLP parameter count; d_sh (n, sh_dim); grad_mlp (P,), the MLP
// gradients in the order of `mlp`; addr_* (levels * n_blocks * 32 * 8,)
// int64 and val_* (the same, n_features) the update stream of each grid, in
// (level, point, corner) order with points past n at the spill address
// levels * T, or null pointers for a frozen grid.
extern "C" int fused_step_backward(const float* points, const float* sh, const float* g_d,
                                   const float* g_c, const float* td, const float* tc,
                                   const void* const* mlp, const int* res, const int* dense_d,
                                   const int* dense_c, const int* dims, float* partials,
                                   float* d_sh, long long* addr_d, float* val_d,
                                   long long* addr_c, float* val_c, float* grad_mlp,
                                   void* stream) {
    Dims d;
    Geom g;
    Mlps m;
    if (!read_args(dims, res, dense_d, dense_c, mlp, &d, &g, &m))
        return static_cast<int>(cudaErrorInvalidValue);
    if (d.n == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d.f) {
        case 1: return launch_bwd<1>(points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 2: return launch_bwd<2>(points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 4: return launch_bwd<4>(points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 8: return launch_bwd<8>(points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The shared-memory bytes a forward / backward block of these widths needs
// (the wrapper checks them against the card's limit before launching).
extern "C" long long fused_step_smem_bytes(const int* dims, int backward) {
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                 dims[6], dims[7], dims[8], dims[9], dims[10]};
    if (backward) return static_cast<long long>(BwdLayout(d).bytes());
    return static_cast<long long>(fwd_smem_floats(d) * sizeof(float));
}
