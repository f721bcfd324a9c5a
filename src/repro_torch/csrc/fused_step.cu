// One-op training step of a decomposed field: both grids' multires encode
// and both MLP heads, forward and backward.
//
// Replaces: src/repro/kernels/fused_step/kernel.py:122 fused_step_pallas
// (body _fused_step_kernel :89, MLP epilogue :110, dedup encode
// _dedup_encode_block :55) and src/repro/kernels/fused_step/kernel.py:266
// fused_step_bwd_pallas (body _fused_step_bwd_kernel :171, in-block BUM
// commit :245-257).
//
// What bounds it on the H100.  Forward: the two MLP heads' ~10,400
// multiply-adds per point, on the tensor cores in split TF32 (three TF32
// products each, at 495 TFLOP/s), against ~2 KB of gathered table rows per
// point, most of them served by the 50 MB L2 that holds both table sets
// (40 MiB).  At the training budgets (8192-32,768 points) neither is near
// its peak: a step is a few microseconds of work, and latency -- the
// weights' trip into shared memory, the gathers' round trips -- bounds it.
// Backward: the two heads recomputed, their data gradients and their weight
// gradients, about three times the forward's multiply-adds, also on the
// tensor cores; the encode's f32 work on the CUDA cores; and the
// table-gradient streams it writes (16 bytes per corner and grid).
//
// Both passes share one tile design.  A block owns tiles of kTilePoints
// Morton-ordered points with kTileThreads threads.  It stages every MLP
// weight into shared memory once (`stage_weights`: asynchronous copies into
// rows padded by mlp_tile::weight_ld, so that B-fragment reads hit distinct
// banks), and while those copies land its threads gather the tile's
// features (`gather_inputs`: (point, level) items, kGatherItems per thread
// at a time so that all their table reads are in flight together; each
// corner row one vector load -- at a 2-byte table (bf16 / f16; both grids
// share one element type) one load of the row's 2F bytes, widened to f32 in
// registers, so the rest of both passes is the f32 table's arithmetic on
// the same values; sentinel rows (x < 0) read row 0 at weight 0, points
// past N give all-zero rows).  Every layer product then runs
// through mlp_tile.cuh's split-TF32 routine on tiles in shared memory; the
// pre-activations z = x W + b come from one helper (`affine`), so the
// backward's recompute gives the forward's own z bit for bit and its ReLU
// masks are the forward's.
//
// Forward design.  The TPU kernel ran a (block, level) grid with the level
// axis innermost, holding one level table per step in VMEM and the block's
// (B, L*F) feature tiles in revisited output blocks, with an MLP epilogue at
// the last level.  A level table (2 MiB) does not fit in shared memory, so
// here the block gathers all L levels of its tile itself, and the epilogue
// runs from shared memory: the features never reach device memory.  Three
// phases, one barrier each: (1) the density head's z and the color head's
// z1, (2) the density output relu(z) W2 + b2, written to out_d by the
// product's epilogue, and z2 = relu(z1) W2 + b2, (3) the color output
// relu(z2) W3 + b3, written to out_c.  At FieldConfig() a block holds ~50
// KB of padded weights and ~37 KB of tiles: two blocks (16 warps) an SM.
// The grid is persistent: as many blocks as fit on the card (the occupancy
// calculator, asked once per device and size), each looping over tiles
// with its weights staged once, or one block per tile when there are fewer
// (one block per tile was as fast at 8192 points and slower at 32,768,
// PERF.md).  The TPU's dedup-as-matmul (sorted in-block addresses,
// W (B, B*8) @ rows) was a way to use the MXU; a straight gather computes
// the same function.
//
// Backward design: deterministic, two passes, no float atomics.  The
// reference writes its backward as block-level matrix products (hd @ w1d,
// h1d.T @ g_d, ...); so does this kernel, on the tensor cores.
//   Pass 1 (fused_step_bwd_kernel): one tile per block.  After the shared
//   staging and gather, it recomputes z (density), z1 and z2 (color) with
//   `affine`, then the data gradients (g W^T times relu'(z), down to the
//   features and d_sh) and the weight gradients (x^T g, summed over the
//   tile's points in a fixed order), the last written as the block's row of
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
//   version's order.  The streams and the commit are f32 whatever the
//   tables' element type; the wrapper casts each committed gradient to its
//   table's dtype after the commit, as the reference does.
// A grid whose table is frozen gets no stream at all (null pointers), as
// the reference dead-code-eliminates its commit.  Corner weights are (w_x *
// w_y) * w_z with the scaled coordinate rounded first, as in the plain
// version.
#include <mutex>
#include <vector>

#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kTilePoints = 32;     // points per tile (forward and backward)
constexpr int kTileThreads = 256;   // threads per block
constexpr int kGroup = 2;           // 8-column tiles per warp unit of a product
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

// d relu(z) / dz with the reference's maximum(z, 0): 1/2 at the tie.
__device__ __forceinline__ float relu_grad(float z) {
    return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
}

// ---- the tile block's shared memory and the helpers both passes call ----

// Shared-memory carve-up of a tile block (floats): every MLP weight with its
// rows padded for conflict-free B-fragment reads, the biases, then the
// tile's activation buffers, each kTilePoints rows: the features (xd, xc =
// [color features, sh]) and three hidden tiles h0 / h1 / h2 (pre-
// activations, and in the backward their gradients); the backward adds the
// cotangents (gd, gc) and the features' gradients (ghd, ghc).
struct TileLayout {
    int ld_w1d, ld_w2d, ld_w1c, ld_w2c, ld_w3c, ld_f, ld_c, ld_gd, ld_gc, ld_h;
    size_t w1d, b1d, w2d, b2d, w1c, b1c, w2c, b2c, w3c, b3c;
    size_t xd, xc, h0, h1, h2, gd, gc, ghd, ghc, floats;

    __host__ __device__ TileLayout(const Dims& d, bool backward) {
        using mlp_tile::act_ld;
        using mlp_tile::weight_ld;
        constexpr int P = kTilePoints;
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
        xd = at;  at += P * ld_f;
        xc = at;  at += P * ld_c;
        h0 = at;  at += P * ld_h;
        h1 = at;  at += P * ld_h;
        h2 = at;  at += P * ld_h;
        gd = gc = ghd = ghc = at;
        if (backward) {
            gd = at;  at += P * ld_gd;
            gc = at;  at += P * ld_gc;
            ghd = at; at += P * ld_f;
            ghc = at; at += P * ld_f;
        }
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

// Every MLP weight and bias into the block's layout, as one committed group
// of asynchronous copies (wait with mlp_tile::wait<0>, then a barrier).
__device__ void stage_weights(float* smem, const TileLayout& lay, const Mlps& m,
                              const Dims& d) {
    stage_rows(smem + lay.w1d, m.w1d, d.feat(), d.hid_d, lay.ld_w1d);
    stage_rows(smem + lay.w2d, m.w2d, d.hid_d, d.out_d, lay.ld_w2d);
    stage_rows(smem + lay.w1c, m.w1c, d.cin(), d.hid_c1, lay.ld_w1c);
    stage_rows(smem + lay.w2c, m.w2c, d.hid_c1, d.hid_c2, lay.ld_w2c);
    stage_rows(smem + lay.w3c, m.w3c, d.hid_c2, d.out_c, lay.ld_w3c);
    stage_flat(smem + lay.b1d, m.b1d, d.hid_d);
    stage_flat(smem + lay.b2d, m.b2d, d.out_d);
    stage_flat(smem + lay.b1c, m.b1c, d.hid_c1);
    stage_flat(smem + lay.b2c, m.b2c, d.hid_c2);
    stage_flat(smem + lay.b3c, m.b3c, d.out_c);
    mlp_tile::commit();
}

// One table row of F elements through the read-only cache as f32, in as few
// loads as its width allows: F floats, or the 2F bytes of F 2-byte elements
// widened in registers.
template <int F, class T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, float (&v)[F]) {
    if constexpr (sizeof(T) == 2) {
        uint32_t w[(F + 1) / 2];
        if constexpr (F == 1) {
            w[0] = __ldg(reinterpret_cast<const unsigned short*>(row));
        } else if constexpr (F == 2) {
            w[0] = __ldg(reinterpret_cast<const unsigned int*>(row));
        } else if constexpr (F == 4) {
            const uint2 x = __ldg(reinterpret_cast<const uint2*>(row));
            w[0] = x.x;
            w[1] = x.y;
        } else {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(row));
            w[0] = x.x;
            w[1] = x.y;
            w[2] = x.z;
            w[3] = x.w;
        }
        widen_row<T, F>(w, v);
    } else if constexpr (F % 4 == 0) {
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

// Both grids' features of the tile's points base .. base + kTilePoints - 1
// into xd and xc (row stride lay.ld_f / lay.ld_c), and their SH after the
// color features; `items` (point, level) items per thread at a time so that
// all their table reads are in flight together (the reads, mostly from L2,
// bound this phase).  Points past the end get all-zero rows, which add
// nothing anywhere.
template <int F, class T>
__device__ void gather_inputs(const float* __restrict__ points, const float* __restrict__ sh,
                              const T* __restrict__ td, const T* __restrict__ tc,
                              const Geom& g, const Dims& d, const TileLayout& lay, int base,
                              float* xd, float* xc) {
    constexpr int P = kTilePoints;
    constexpr int kGatherItems = kGatherRows / (8 * F) > 0 ? kGatherRows / (8 * F) : 1;
    const int levels = d.levels;
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
            const T* tbl_d = td + static_cast<size_t>(live ? l : 0) * d.table_d * F;
            const T* tbl_c = tc + static_cast<size_t>(live ? l : 0) * d.table_c * F;
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
    const int feat = d.feat();
    for (int e = threadIdx.x; e < P * d.sh; e += blockDim.x) {
        const int p = e / d.sh, k = e - p * d.sh, i = base + p;
        xc[p * lay.ld_c + feat + k] = i < d.n ? sh[static_cast<size_t>(i) * d.sh + k] : 0.0f;
    }
}

// Operands of the tile products: X (points x width, a row-major tile), its
// ReLU (a pre-activation tile read as its activation), and W (k x n, a
// staged weight).
using mlp_tile::Strided;
__device__ __forceinline__ Strided<> tile_x(const float* t, int ld, int cols) {
    return Strided<>{t, ld, 1, kTilePoints, cols};
}
__device__ __forceinline__ Strided<true> tile_relu(const float* t, int ld, int cols) {
    return Strided<true>{t, ld, 1, kTilePoints, cols};
}
__device__ __forceinline__ Strided<> weight(const float* w, int ld, int k, int n) {
    return Strided<>{w, ld, 1, k, n};
}

// z = x W + b for the tile (kTilePoints x n, row stride ldz), every warp of
// the block sharing the units: the pre-activation both passes compute.
template <class X>
__device__ __forceinline__ void affine(const X& x, const float* w, int ld_w, const float* b,
                                       int k, int n, float* z, int ldz) {
    mlp_tile::gemm<kGroup>(x, weight(w, ld_w, k, n), kTilePoints, n, k,
                           [&](int r, int c, float v) { z[r * ldz + c] = v + b[c]; },
                           threadIdx.x >> 5, blockDim.x >> 5);
}

// ---- forward ----

template <int F, class T>
__global__ void __launch_bounds__(kTileThreads, 2)
fused_step_fwd_kernel(const float* __restrict__ points, const float* __restrict__ sh,
                      const T* __restrict__ td, const T* __restrict__ tc,
                      const Mlps m, const Geom g, const Dims d,
                      float* __restrict__ out_d, float* __restrict__ out_c) {
    extern __shared__ __align__(16) float smem[];
    const TileLayout lay(d, false);
    const int feat = d.feat(), cin = d.cin(), ldh = lay.ld_h;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const float* b2d = smem + lay.b2d;
    const float* b3c = smem + lay.b3c;
    float* xd = smem + lay.xd;   float* xc = smem + lay.xc;
    float* h0 = smem + lay.h0;   float* h1 = smem + lay.h1;   float* h2 = smem + lay.h2;
    stage_weights(smem, lay, m, d);

    const int n_tiles = (d.n + kTilePoints - 1) / kTilePoints;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int base = tile * kTilePoints;
        gather_inputs<F>(points, sh, td, tc, g, d, lay, base, xd, xc);
        mlp_tile::wait<0>();    // this thread's weight copies have landed
        __syncthreads();
        // (1) density z (h0), color z1 (h1)
        affine(tile_x(xd, lay.ld_f, feat), smem + lay.w1d, lay.ld_w1d, smem + lay.b1d, feat,
               d.hid_d, h0, ldh);
        affine(tile_x(xc, lay.ld_c, cin), smem + lay.w1c, lay.ld_w1c, smem + lay.b1c, cin,
               d.hid_c1, h1, ldh);
        __syncthreads();
        // (2) the density output relu(z) W2 + b2; color z2 = relu(z1) W2 + b2 (h2)
        mlp_tile::gemm<kGroup>(tile_relu(h0, ldh, d.hid_d),
                               weight(smem + lay.w2d, lay.ld_w2d, d.hid_d, d.out_d),
                               kTilePoints, d.out_d, d.hid_d,
                               [&](int r, int c, float v) {
                                   if (base + r < d.n)
                                       out_d[static_cast<size_t>(base + r) * d.out_d + c] =
                                           v + b2d[c];
                               },
                               warp, n_warps);
        affine(tile_relu(h1, ldh, d.hid_c1), smem + lay.w2c, lay.ld_w2c, smem + lay.b2c,
               d.hid_c1, d.hid_c2, h2, ldh);
        __syncthreads();
        // (3) the color output relu(z2) W3 + b3.  No barrier after it: the
        // next tile's gather writes xd / xc, last read in (1), and its (2)
        // rewrites h2 only after the next tile's barriers.
        mlp_tile::gemm<kGroup>(tile_relu(h2, ldh, d.hid_c2),
                               weight(smem + lay.w3c, lay.ld_w3c, d.hid_c2, d.out_c),
                               kTilePoints, d.out_c, d.hid_c2,
                               [&](int r, int c, float v) {
                                   if (base + r < d.n)
                                       out_c[static_cast<size_t>(base + r) * d.out_c + c] =
                                           v + b3c[c];
                               },
                               warp, n_warps);
    }
}

// ---- backward, pass 1 ----

// Column sums of a kTilePoints-row tile, each summed over the points in order.
__device__ void column_sums(const float* tile, int ld, int n, float* __restrict__ out) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float s = 0.0f;
        for (int r = 0; r < kTilePoints; ++r) s = __fadd_rn(s, tile[r * ld + c]);
        out[c] = s;
    }
}

template <int F, class T>
__global__ void __launch_bounds__(kTileThreads)
fused_step_bwd_kernel(const float* __restrict__ points, const float* __restrict__ sh,
                      const float* __restrict__ g_d, const float* __restrict__ g_c,
                      const T* __restrict__ td, const T* __restrict__ tc,
                      const Mlps m, const Geom g, const Dims d,
                      float* __restrict__ partials, float* __restrict__ d_sh,
                      long long* __restrict__ addr_d, float* __restrict__ val_d,
                      long long* __restrict__ addr_c, float* __restrict__ val_c) {
    extern __shared__ __align__(16) float smem[];
    const TileLayout lay(d, true);
    const int feat = d.feat(), cin = d.cin(), levels = d.levels;
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int base = blockIdx.x * kTilePoints;
    constexpr int P = kTilePoints;

    float* w1d = smem + lay.w1d;
    float* w2d = smem + lay.w2d;
    float* w1c = smem + lay.w1c;
    float* w2c = smem + lay.w2c;
    float* w3c = smem + lay.w3c;
    float* xd = smem + lay.xd;   float* xc = smem + lay.xc;
    float* gd = smem + lay.gd;   float* gc = smem + lay.gc;
    float* ghd = smem + lay.ghd; float* ghc = smem + lay.ghc;
    float* h0 = smem + lay.h0;   float* h1 = smem + lay.h1;   float* h2 = smem + lay.h2;

    stage_weights(smem, lay, m, d);
    gather_inputs<F>(points, sh, td, tc, g, d, lay, base, xd, xc);
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

    // operands: X^T (x^T g) and W^T (g W^T), beside tile_x / tile_relu / weight
    auto XT = [](const float* t, int ld, int cols) { return Strided<>{t, 1, ld, cols, P}; };
    auto XTR = [](const float* t, int ld, int cols) {
        return Strided<true>{t, 1, ld, cols, P}; };
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
    affine(tile_x(xd, lay.ld_f, feat), w1d, lay.ld_w1d, smem + lay.b1d, feat, d.hid_d, h0, ldh);
    __syncthreads();
    mlp_tile::gemm<kGroup>(tile_x(gd, lay.ld_gd, d.out_d), WT(w2d, lay.ld_w2d, d.hid_d, d.out_d),
                           P, d.hid_d, d.out_d,
                           [&](int r, int c, float v) {
                               h1[r * ldh + c] = v * relu_grad(h0[r * ldh + c]); },
                           warp, n_warps);
    __syncthreads();
    // g_x = g_h W1^T; dW1 = x^T g_h; dW2 = relu(z)^T g_d; biases
    mlp_tile::gemm<kGroup>(tile_x(h1, ldh, d.hid_d), WT(w1d, lay.ld_w1d, feat, d.hid_d), P,
                           feat, d.hid_d,
                           [&](int r, int c, float v) { ghd[r * lay.ld_f + c] = v; },
                           warp, n_warps);
    mlp_tile::gemm<kGroup>(XT(xd, lay.ld_f, feat), tile_x(h1, ldh, d.hid_d), feat, d.hid_d, P,
                           [&](int r, int c, float v) { row[o_w1d + r * d.hid_d + c] = v; },
                           warp, n_warps);
    mlp_tile::gemm<kGroup>(XTR(h0, ldh, d.hid_d), tile_x(gd, lay.ld_gd, d.out_d), d.hid_d,
                           d.out_d, P,
                           [&](int r, int c, float v) { row[o_w2d + r * d.out_d + c] = v; },
                           warp, n_warps);
    column_sums(h1, ldh, d.hid_d, row + o_b1d);
    column_sums(gd, lay.ld_gd, d.out_d, row + o_b2d);
    __syncthreads();

    // color head on [color features, sh]: z1 (h0), z2 (h2)
    affine(tile_x(xc, lay.ld_c, cin), w1c, lay.ld_w1c, smem + lay.b1c, cin, d.hid_c1, h0, ldh);
    __syncthreads();
    affine(tile_relu(h0, ldh, d.hid_c1), w2c, lay.ld_w2c, smem + lay.b2c, d.hid_c1, d.hid_c2,
           h2, ldh);
    __syncthreads();
    // g_h2 = (g_c W3^T) relu'(z2) (h1); dW3 = relu(z2)^T g_c
    mlp_tile::gemm<kGroup>(tile_x(gc, lay.ld_gc, d.out_c), WT(w3c, lay.ld_w3c, d.hid_c2, d.out_c),
                           P, d.hid_c2, d.out_c,
                           [&](int r, int c, float v) {
                               h1[r * ldh + c] = v * relu_grad(h2[r * ldh + c]); },
                           warp, n_warps);
    mlp_tile::gemm<kGroup>(XTR(h2, ldh, d.hid_c2), tile_x(gc, lay.ld_gc, d.out_c), d.hid_c2,
                           d.out_c, P,
                           [&](int r, int c, float v) { row[o_w3c + r * d.out_c + c] = v; },
                           warp, n_warps);
    column_sums(gc, lay.ld_gc, d.out_c, row + o_b3c);
    __syncthreads();
    // g_h1 = (g_h2 W2^T) relu'(z1) (h2); dW2 = relu(z1)^T g_h2
    mlp_tile::gemm<kGroup>(tile_x(h1, ldh, d.hid_c2), WT(w2c, lay.ld_w2c, d.hid_c1, d.hid_c2), P,
                           d.hid_c1, d.hid_c2,
                           [&](int r, int c, float v) {
                               h2[r * ldh + c] = v * relu_grad(h0[r * ldh + c]); },
                           warp, n_warps);
    mlp_tile::gemm<kGroup>(XTR(h0, ldh, d.hid_c1), tile_x(h1, ldh, d.hid_c2), d.hid_c1,
                           d.hid_c2, P,
                           [&](int r, int c, float v) { row[o_w2c + r * d.hid_c2 + c] = v; },
                           warp, n_warps);
    column_sums(h1, ldh, d.hid_c2, row + o_b2c);
    __syncthreads();
    // g_cin = g_h1 W1^T -> the color features' gradient and d_sh; dW1 = cin^T g_h1
    mlp_tile::gemm<kGroup>(tile_x(h2, ldh, d.hid_c1), WT(w1c, lay.ld_w1c, cin, d.hid_c1), P, cin,
                           d.hid_c1,
                           [&](int r, int c, float v) {
                               if (c < feat) {
                                   ghc[r * lay.ld_f + c] = v;
                               } else if (base + r < d.n) {
                                   d_sh[static_cast<size_t>(base + r) * d.sh + (c - feat)] = v;
                               }
                           },
                           warp, n_warps);
    mlp_tile::gemm<kGroup>(XT(xc, lay.ld_c, cin), tile_x(h2, ldh, d.hid_c1), cin, d.hid_c1, P,
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

// How many blocks of fused_step_fwd_kernel<F, T> with `bytes` of shared memory
// `device` holds at once (the occupancy calculator), 0 if none fits.  The
// first launch at a (device, size) asks the runtime and allows the kernel
// that much shared memory; later ones read the answer back.
template <int F, class T>
int resident_fwd_blocks(size_t bytes, int device) {
    struct Seen { int device; size_t bytes; int blocks; };
    static std::mutex mu;
    static std::vector<Seen> seen;
    const std::lock_guard<std::mutex> lock(mu);
    size_t allowed = 0;    // the most this device was allowed so far
    for (const Seen& s : seen) {
        if (s.device != device) continue;
        if (s.bytes == bytes) return s.blocks;
        allowed = s.bytes > allowed ? s.bytes : allowed;
    }
    int sms = 0, per_sm = 0;
    if ((bytes > allowed &&
         cudaFuncSetAttribute(fused_step_fwd_kernel<F, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) != cudaSuccess) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_fwd_kernel<F, T>,
                                                      kTileThreads, bytes) != cudaSuccess)
        return 0;
    seen.push_back({device, bytes, per_sm * sms});
    return per_sm * sms;
}

// The forward's grid: one block per free slot on the card, each looping
// over tiles (its weights staged once), or one per tile when the tiles run
// out first.
template <int F, class T>
int launch_fwd(const float* points, const float* sh, const T* td, const T* tc,
               const Mlps& m, const Geom& g, const Dims& d, float* out_d, float* out_c,
               cudaStream_t s) {
    const size_t bytes = TileLayout(d, false).bytes();
    if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    int device = 0;
    cudaGetDevice(&device);
    const int slots = resident_fwd_blocks<F, T>(bytes, device);
    if (slots < 1) {
        const cudaError_t err = cudaGetLastError();
        return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
    const int tiles = (d.n + kTilePoints - 1) / kTilePoints;
    fused_step_fwd_kernel<F, T><<<tiles < slots ? tiles : slots, kTileThreads, bytes, s>>>(
        points, sh, td, tc, m, g, d, out_d, out_c);
    return static_cast<int>(cudaGetLastError());
}

template <int F, class T>
int launch_bwd(const float* points, const float* sh, const float* g_d, const float* g_c,
               const T* td, const T* tc, const Mlps& m, const Geom& g, const Dims& d,
               float* partials, float* d_sh, long long* addr_d, float* val_d,
               long long* addr_c, float* val_c, float* grad_mlp, cudaStream_t s) {
    const TileLayout lay(d, true);
    const size_t bytes = lay.bytes();
    if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(fused_step_bwd_kernel<F, T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    const int blocks = (d.n + kTilePoints - 1) / kTilePoints;
    fused_step_bwd_kernel<F, T><<<blocks, kTileThreads, bytes, s>>>(
        points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh, addr_d, val_d, addr_c, val_c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_step_reduce_kernel<<<(d.n_params() + kReduceCols - 1) / kReduceCols,
                               kReduceThreads, 0, s>>>(partials, blocks, d.n_params(),
                                                       grad_mlp);
    return static_cast<int>(cudaGetLastError());
}

// The forward / backward at the table element type T, dispatched on F.
template <class T>
int forward_features(const float* points, const float* sh, const void* td, const void* tc,
                     const Mlps& m, const Geom& g, const Dims& d, float* out_d, float* out_c,
                     cudaStream_t s) {
    const T* a = static_cast<const T*>(td);
    const T* b = static_cast<const T*>(tc);
    switch (d.f) {
        case 1: return launch_fwd<1>(points, sh, a, b, m, g, d, out_d, out_c, s);
        case 2: return launch_fwd<2>(points, sh, a, b, m, g, d, out_d, out_c, s);
        case 4: return launch_fwd<4>(points, sh, a, b, m, g, d, out_d, out_c, s);
        case 8: return launch_fwd<8>(points, sh, a, b, m, g, d, out_d, out_c, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <class T>
int backward_features(const float* points, const float* sh, const float* g_d, const float* g_c,
                      const void* td, const void* tc, const Mlps& m, const Geom& g,
                      const Dims& d, float* partials, float* d_sh, long long* addr_d,
                      float* val_d, long long* addr_c, float* val_c, float* grad_mlp,
                      cudaStream_t s) {
    const T* a = static_cast<const T*>(td);
    const T* b = static_cast<const T*>(tc);
    switch (d.f) {
        case 1: return launch_bwd<1>(points, sh, g_d, g_c, a, b, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 2: return launch_bwd<2>(points, sh, g_d, g_c, a, b, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 4: return launch_bwd<4>(points, sh, g_d, g_c, a, b, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        case 8: return launch_bwd<8>(points, sh, g_d, g_c, a, b, m, g, d, partials, d_sh,
                                     addr_d, val_d, addr_c, val_c, grad_mlp, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Dims (11 host ints): n, levels, n_features, sh_dim, T_density, T_color,
// density hidden, density outputs, color hidden 1, color hidden 2, color
// outputs.  mlp: host array of the 10 device pointers w1d b1d w2d b2d w1c b1c
// w2c b2c w3c b3c ((d_in, d_out) layout).  res / dense_d / dense_c: host
// arrays of `levels` ints.  points (n, 3), sh (n, sh_dim), out_d (n, density
// outputs), out_c (n, color outputs): f32, contiguous; tables (L, T, F),
// contiguous, both of the element type `table_type` (TableType: f32, bf16,
// f16).
extern "C" int fused_step_forward(const float* points, const float* sh, const void* td,
                                  const void* tc, const void* const* mlp, const int* res,
                                  const int* dense_d, const int* dense_c, const int* dims,
                                  int table_type, float* out_d, float* out_c, void* stream) {
    Dims d;
    Geom g;
    Mlps m;
    if (!read_args(dims, res, dense_d, dense_c, mlp, &d, &g, &m))
        return static_cast<int>(cudaErrorInvalidValue);
    if (d.n == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return with_table_type(table_type, [&](auto tag) {
        using T = typename decltype(tag)::type;
        return forward_features<T>(points, sh, td, tc, m, g, d, out_d, out_c, s);
    });
}

// As the forward, plus: g_d (n, density outputs) and g_c (n, color outputs)
// the cotangents; partials (n_blocks, P) scratch with n_blocks = ceil(n / 32)
// and P the MLP parameter count; d_sh (n, sh_dim); grad_mlp (P,), the MLP
// gradients in the order of `mlp`; addr_* (levels * n_blocks * 32 * 8,)
// int64 and val_* (the same, n_features) the update stream of each grid, in
// (level, point, corner) order with points past n at the spill address
// levels * T, or null pointers for a frozen grid.  The streams are f32
// whatever the tables' element type.
extern "C" int fused_step_backward(const float* points, const float* sh, const float* g_d,
                                   const float* g_c, const void* td, const void* tc,
                                   const void* const* mlp, const int* res, const int* dense_d,
                                   const int* dense_c, const int* dims, int table_type,
                                   float* partials,
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
    return with_table_type(table_type, [&](auto tag) {
        using T = typename decltype(tag)::type;
        return backward_features<T>(points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh,
                                    addr_d, val_d, addr_c, val_c, grad_mlp, s);
    });
}

// The shared-memory bytes a forward / backward block of these widths needs
// (the wrapper checks them against the card's limit before launching).
extern "C" long long fused_step_smem_bytes(const int* dims, int backward) {
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                 dims[6], dims[7], dims[8], dims[9], dims[10]};
    return static_cast<long long>(TileLayout(d, backward != 0).bytes());
}
