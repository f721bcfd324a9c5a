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
// (40 MiB).  Backward: the same operations about three times over, plus the
// block's update streams.  The arithmetic is plain f32 FMA on the CUDA cores
// (no tensor cores), so that the results match the f32 plain version.
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
// Backward design: deterministic, two passes, no float atomics.
//   Pass 1 (fused_step_bwd_kernel, kBwdPoints points per block): recompute
//   both grids' features and every MLP activation from the (Morton-sorted)
//   points, run both heads' backward per point, then
//   * write the block's MLP weight-gradient partial sums, each summed over
//     the block's points in order, to row blockIdx.x of partials (n_blocks, P);
//   * write d_sh;
//   * for each (level, grid), merge the block's B*8 corner updates in the
//     block -- the in-block BUM: a bitonic sort in shared memory on
//     (address, stream position), so equal addresses stay in stream order,
//     then the thread at each run start sums its run and writes one
//     (address + l*T, sum) entry at the run start's slot; every other slot
//     gets the spill address L*T with value 0.
//   Pass 2: fused_step_reduce sums the partials over blocks in block order;
//   the wrapper then orders the per-block runs by address across blocks with
//   a stable torch.sort (the glue jnp.argsort is in the reference) and
//   commits them with the bum_scatter kernel, which drops the spill entries.
// A grid whose table is frozen gets no stream at all (null pointers), as
// the reference dead-code-eliminates its commit.  Products that feed the
// table gradients are rounded as the plain version rounds them
// (__fmul_rn / __fadd_rn), and corner weights are (w_x * w_y) * w_z with
// the scaled coordinate rounded first, as in the plain version.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kFwdPoints = 128;     // points (= threads) per forward block
constexpr int kBwdPoints = 64;      // points (= threads) per backward block
constexpr int kSort = kBwdPoints * 8;
constexpr int kMaxOutD = 16;        // density head outputs (1 + geo)
constexpr int kMaxOutC = 4;         // color head outputs (3)
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr unsigned long long kInvalid = ~0ull;

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

// Shared-memory carve-up of the backward block: the two sort key arrays
// first (8-byte aligned), then the corner weights of the current level, the
// staged weights, and one row per point of each per-point quantity.
struct BwdLayout {
    int ld_xd, ld_xc, ld_gd, ld_gc, ld_hd, ld_h1, ld_h2;
    size_t weights, xd, xc, gd, gc, zd, ghd1, ghd, z1c, z2c, gh2c, gh1c, ghc, floats;

    __host__ __device__ explicit BwdLayout(const Dims& d) {
        ld_xd = odd(d.feat());
        ld_xc = odd(d.cin());
        ld_gd = odd(d.out_d);
        ld_gc = odd(d.out_c);
        ld_hd = odd(d.hid_d);
        ld_h1 = odd(d.hid_c1);
        ld_h2 = odd(d.hid_c2);
        size_t at = kSort;                       // corner weights of one level
        weights = at; at += d.n_params();
        xd = at;   at += kBwdPoints * ld_xd;     // density features
        xc = at;   at += kBwdPoints * ld_xc;     // [color features, sh]
        gd = at;   at += kBwdPoints * ld_gd;     // cotangent of the density head
        gc = at;   at += kBwdPoints * ld_gc;     // cotangent of the color head
        zd = at;   at += kBwdPoints * ld_hd;     // density hidden pre-activation
        ghd1 = at; at += kBwdPoints * ld_hd;     // its gradient
        ghd = at;  at += kBwdPoints * ld_xd;     // gradient of the density features
        z1c = at;  at += kBwdPoints * ld_h1;     // color hidden 1 pre-activation
        z2c = at;  at += kBwdPoints * ld_h2;     // color hidden 2 pre-activation
        gh2c = at; at += kBwdPoints * ld_h2;
        gh1c = at; at += kBwdPoints * ld_h1;
        ghc = at;  at += kBwdPoints * ld_xd;     // gradient of the color features
        floats = at;
    }
    __host__ __device__ size_t bytes() const {
        return 2 * kSort * sizeof(unsigned long long) + floats * sizeof(float);
    }
};

// One (level, grid) of the in-block BUM: the sorted keys (address << 32 |
// stream position p*8 + c) become one (address + l*T, run sum) entry at each
// run start's slot and a spill entry everywhere else.
template <int F>
__device__ void commit_runs(const unsigned long long* keys, const float* cw,
                            const float* gfeat, int ld, int level, int table_size,
                            long long spill, long long* addr_out, float* val_out) {
    for (int i = threadIdx.x; i < kSort; i += blockDim.x) {
        const unsigned long long key = keys[i];
        const unsigned long long a = key >> 32;
        const bool start = key != kInvalid && (i == 0 || (keys[i - 1] >> 32) != a);
        if (!start) {
            addr_out[i] = spill;
#pragma unroll
            for (int f = 0; f < F; ++f) val_out[static_cast<size_t>(i) * F + f] = 0.0f;
            continue;
        }
        float sum[F];
#pragma unroll
        for (int f = 0; f < F; ++f) sum[f] = 0.0f;
        for (int j = i; j < kSort && keys[j] != kInvalid && (keys[j] >> 32) == a; ++j) {
            const int pos = static_cast<int>(keys[j] & 0xffffffffull);
            const float* gr = gfeat + (pos >> 3) * ld + level * F;
#pragma unroll
            for (int f = 0; f < F; ++f) sum[f] = __fadd_rn(sum[f], __fmul_rn(cw[pos], gr[f]));
        }
        addr_out[i] = static_cast<long long>(level) * table_size + static_cast<long long>(a);
#pragma unroll
        for (int f = 0; f < F; ++f) val_out[static_cast<size_t>(i) * F + f] = sum[f];
    }
}

template <int F>
__global__ void __launch_bounds__(kBwdPoints)
fused_step_bwd_kernel(const float* __restrict__ points, const float* __restrict__ sh,
                      const float* __restrict__ g_d, const float* __restrict__ g_c,
                      const float* __restrict__ td, const float* __restrict__ tc,
                      const Mlps m, const Geom g, const Dims d,
                      float* __restrict__ partials, float* __restrict__ d_sh,
                      long long* __restrict__ addr_d, float* __restrict__ val_d,
                      long long* __restrict__ addr_c, float* __restrict__ val_c) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned long long* keys_d = reinterpret_cast<unsigned long long*>(smem_raw);
    unsigned long long* keys_c = keys_d + kSort;
    float* fbase = reinterpret_cast<float*>(keys_c + kSort);
    const BwdLayout lay(d);
    float* cw = fbase;                      // corner weights of the current level
    const SmemWeights w = stage_weights(fbase + lay.weights, m, d);

    const int p = threadIdx.x;
    const int i = blockIdx.x * kBwdPoints + p;
    const bool valid = i < d.n;
    const int feat = d.feat(), cin = d.cin();
    float* xd = fbase + lay.xd + p * lay.ld_xd;
    float* xc = fbase + lay.xc + p * lay.ld_xc;
    float* gd = fbase + lay.gd + p * lay.ld_gd;
    float* gc = fbase + lay.gc + p * lay.ld_gc;
    float* zd = fbase + lay.zd + p * lay.ld_hd;
    float* ghd1 = fbase + lay.ghd1 + p * lay.ld_hd;
    float* ghd = fbase + lay.ghd + p * lay.ld_xd;
    float* z1c = fbase + lay.z1c + p * lay.ld_h1;
    float* z2c = fbase + lay.z2c + p * lay.ld_h2;
    float* gh2c = fbase + lay.gh2c + p * lay.ld_h2;
    float* gh1c = fbase + lay.gh1c + p * lay.ld_h1;
    float* ghc = fbase + lay.ghc + p * lay.ld_xd;

    if (valid) {
        // recompute: features, then every activation, then each head's backward
        encode_point<F>(points, i, td, tc, g, d, xd, xc);
        for (int k = 0; k < d.sh; ++k) xc[feat + k] = sh[static_cast<size_t>(i) * d.sh + k];
        for (int o = 0; o < d.out_d; ++o) gd[o] = g_d[static_cast<size_t>(i) * d.out_d + o];
        for (int o = 0; o < d.out_c; ++o) gc[o] = g_c[static_cast<size_t>(i) * d.out_c + o];
    } else {
        // a point past the end: all-zero rows add nothing to the partials
        for (int k = 0; k < feat; ++k) xd[k] = 0.0f;
        for (int k = 0; k < cin; ++k) xc[k] = 0.0f;
        for (int o = 0; o < d.out_d; ++o) gd[o] = 0.0f;
        for (int o = 0; o < d.out_c; ++o) gc[o] = 0.0f;
        for (int j = 0; j < d.hid_d; ++j) zd[j] = ghd1[j] = 0.0f;
        for (int j = 0; j < d.hid_c1; ++j) z1c[j] = gh1c[j] = 0.0f;
        for (int j = 0; j < d.hid_c2; ++j) z2c[j] = gh2c[j] = 0.0f;
        for (int k = 0; k < feat; ++k) ghd[k] = ghc[k] = 0.0f;
    }
    __syncthreads();    // staged weights visible to every thread

    if (valid) {
        // density head
        for (int j = 0; j < d.hid_d; ++j) {
            float s = 0.0f;
            for (int k = 0; k < feat; ++k) s += xd[k] * w.w1d[k * d.hid_d + j];
            zd[j] = s + w.b1d[j];
        }
        for (int j = 0; j < d.hid_d; ++j) {
            float s = 0.0f;
            for (int o = 0; o < d.out_d; ++o) s += gd[o] * w.w2d[j * d.out_d + o];
            ghd1[j] = s * relu_grad(zd[j]);
        }
        for (int k = 0; k < feat; ++k) {
            float s = 0.0f;
            for (int j = 0; j < d.hid_d; ++j) s += ghd1[j] * w.w1d[k * d.hid_d + j];
            ghd[k] = s;
        }
        // color head
        for (int j = 0; j < d.hid_c1; ++j) {
            float s = 0.0f;
            for (int k = 0; k < cin; ++k) s += xc[k] * w.w1c[k * d.hid_c1 + j];
            z1c[j] = s + w.b1c[j];
        }
        for (int j = 0; j < d.hid_c2; ++j) {
            float s = 0.0f;
            for (int k = 0; k < d.hid_c1; ++k) s += fmaxf(z1c[k], 0.0f) * w.w2c[k * d.hid_c2 + j];
            z2c[j] = s + w.b2c[j];
        }
        for (int j = 0; j < d.hid_c2; ++j) {
            float s = 0.0f;
            for (int o = 0; o < d.out_c; ++o) s += gc[o] * w.w3c[j * d.out_c + o];
            gh2c[j] = s * relu_grad(z2c[j]);
        }
        for (int k = 0; k < d.hid_c1; ++k) {
            float s = 0.0f;
            for (int j = 0; j < d.hid_c2; ++j) s += gh2c[j] * w.w2c[k * d.hid_c2 + j];
            gh1c[k] = s * relu_grad(z1c[k]);
        }
        for (int k = 0; k < cin; ++k) {
            float s = 0.0f;
            for (int j = 0; j < d.hid_c1; ++j) s += gh1c[j] * w.w1c[k * d.hid_c1 + j];
            if (k < feat) ghc[k] = s;
            else d_sh[static_cast<size_t>(i) * d.sh + (k - feat)] = s;
        }
    }
    __syncthreads();    // every point's rows complete

    // the block's weight-gradient partials, each summed over its points in order
    const float* XD = fbase + lay.xd;
    const float* XC = fbase + lay.xc;
    const float* GD = fbase + lay.gd;
    const float* GC = fbase + lay.gc;
    const float* ZD = fbase + lay.zd;
    const float* GHD1 = fbase + lay.ghd1;
    const float* Z1C = fbase + lay.z1c;
    const float* Z2C = fbase + lay.z2c;
    const float* GH2C = fbase + lay.gh2c;
    const float* GH1C = fbase + lay.gh1c;
    float* row = partials + static_cast<size_t>(blockIdx.x) * d.n_params();
    const int sizes[10] = {feat * d.hid_d, d.hid_d, d.hid_d * d.out_d, d.out_d,
                           cin * d.hid_c1, d.hid_c1, d.hid_c1 * d.hid_c2, d.hid_c2,
                           d.hid_c2 * d.out_c, d.out_c};
    int base = 0;
    for (int a = 0; a < 10; ++a) {
        for (int e = threadIdx.x; e < sizes[a]; e += blockDim.x) {
            float s = 0.0f;
            for (int q = 0; q < kBwdPoints; ++q) {
                float u = 1.0f, v = 0.0f;
                switch (a) {
                    case 0: { const int k = e / d.hid_d, j = e % d.hid_d;
                              u = XD[q * lay.ld_xd + k]; v = GHD1[q * lay.ld_hd + j]; break; }
                    case 1: v = GHD1[q * lay.ld_hd + e]; break;
                    case 2: { const int j = e / d.out_d, o = e % d.out_d;
                              u = fmaxf(ZD[q * lay.ld_hd + j], 0.0f); v = GD[q * lay.ld_gd + o];
                              break; }
                    case 3: v = GD[q * lay.ld_gd + e]; break;
                    case 4: { const int k = e / d.hid_c1, j = e % d.hid_c1;
                              u = XC[q * lay.ld_xc + k]; v = GH1C[q * lay.ld_h1 + j]; break; }
                    case 5: v = GH1C[q * lay.ld_h1 + e]; break;
                    case 6: { const int k = e / d.hid_c2, j = e % d.hid_c2;
                              u = fmaxf(Z1C[q * lay.ld_h1 + k], 0.0f);
                              v = GH2C[q * lay.ld_h2 + j]; break; }
                    case 7: v = GH2C[q * lay.ld_h2 + e]; break;
                    case 8: { const int j = e / d.out_c, o = e % d.out_c;
                              u = fmaxf(Z2C[q * lay.ld_h2 + j], 0.0f); v = GC[q * lay.ld_gc + o];
                              break; }
                    default: v = GC[q * lay.ld_gc + e]; break;
                }
                s += u * v;
            }
            row[base + e] = s;
        }
        base += sizes[a];
    }

    // table gradients: the in-block BUM per (level, grid)
    if (addr_d == nullptr && addr_c == nullptr) return;
    const float px = valid ? points[3 * i] : 0.0f;
    const float py = valid ? points[3 * i + 1] : 0.0f;
    const float pz = valid ? points[3 * i + 2] : 0.0f;
    const float* GHD = fbase + lay.ghd;
    const float* GHC = fbase + lay.ghc;
    for (int l = 0; l < d.levels; ++l) {
        const LevelPoint q = level_point(px, py, pz, g.res[l]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int pos = p * 8 + c;
            cw[pos] = corner_weight(q, c);
            const unsigned long long low = static_cast<unsigned long long>(pos);
            keys_d[pos] = valid ? (static_cast<unsigned long long>(
                                       corner_index(q, c, g.dense_d[l] != 0, d.table_d)) << 32) | low
                                : kInvalid;
            keys_c[pos] = valid ? (static_cast<unsigned long long>(
                                       corner_index(q, c, g.dense_c[l] != 0, d.table_c)) << 32) | low
                                : kInvalid;
        }
        __syncthreads();
        const size_t slot = (static_cast<size_t>(blockIdx.x) * d.levels + l) * kSort;
        if (addr_d != nullptr) {
            bitonic_sort<kSort>(keys_d);
            commit_runs<F>(keys_d, cw, GHD, lay.ld_xd, l, d.table_d,
                           static_cast<long long>(d.levels) * d.table_d,
                           addr_d + slot, val_d + slot * F);
        }
        if (addr_c != nullptr) {
            bitonic_sort<kSort>(keys_c);
            commit_runs<F>(keys_c, cw, GHC, lay.ld_xd, l, d.table_c,
                           static_cast<long long>(d.levels) * d.table_c,
                           addr_c + slot, val_c + slot * F);
        }
        __syncthreads();    // keys and weights are rewritten for the next level
    }
}

// ---- backward, pass 2: the partials summed over blocks in block order ----

__global__ void fused_step_reduce_kernel(const float* __restrict__ partials, int n_blocks,
                                         int n_params, float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_params) return;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b)
        s = __fadd_rn(s, partials[static_cast<size_t>(b) * n_params + e]);
    out[e] = s;
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
    fused_step_bwd_kernel<F><<<blocks, kBwdPoints, bytes, s>>>(
        points, sh, g_d, g_c, td, tc, m, g, d, partials, d_sh, addr_d, val_d, addr_c, val_c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    fused_step_reduce_kernel<<<(d.n_params() + threads - 1) / threads, threads, 0, s>>>(
        partials, blocks, d.n_params(), grad_mlp);
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
// the cotangents; partials (n_blocks, P) scratch with n_blocks = ceil(n / 64)
// and P the MLP parameter count; d_sh (n, sh_dim); grad_mlp (P,), the MLP
// gradients in the order of `mlp`; addr_* (n_blocks * levels * 512,) int64
// and val_* (the same, n_features) the merged update stream of each grid, or
// null pointers for a frozen grid.
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
