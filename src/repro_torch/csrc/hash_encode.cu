// Multiresolution hash-grid encode, forward (Instant-NGP step 3-1).
//
// Replaces: src/repro/kernels/hash_encode/kernel.py:98 hash_encode_pallas
// (body _encode_kernel :83, corner enumeration corner_indices_block :36).
//
// What bounds it on the H100: memory.  Every (point, level) pair gathers 8
// table rows of F floats at data-dependent addresses and does ~60 flops on
// them, far below the card's 20 flop/byte balance point.  The TPU kernel held
// a whole level table in VMEM.  Here a level of the density table
// (2^18 x 2 x 4 B = 2 MiB) cannot sit in shared memory (227 KB per block),
// but both full table sets together (16 levels x 2 MiB = 32 MiB density +
// 8 MiB color) fit in the H100's 50 MB L2, so after the first touch the
// gathers are served from L2, not HBM.  What the card moves is then the
// gathers' L2 sectors and the output (N x L*F floats, 25 MB for a dense
// serving chunk), which streams through the same L2.
//
// Design: a block owns a tile of 32 points across all L levels.  Warp l
// computes level l for the tile's 32 points (lane = point), so one gather
// instruction of a warp reads one level table for 32 neighbouring points:
// ray-ordered and Morton-ordered points share corners and sectors there.
// Each thread loads its point once, computes the corner indices in 32-bit
// arithmetic, and reads each corner row with one vector load (float2 at
// F=2; two float4 at F=8; at a 2-byte table (bf16 / f16) one load of the
// row's 2F bytes, a 32-bit load at F=2, widened to f32 in registers)
// through the read-only path: a 2-byte table halves the gathers' bytes and
// the arithmetic is the f32 table's, on the same f32 values.  The tile's features
// are staged in shared memory (row stride L*F + min(F, 4) floats, which
// keeps a warp's stores free of bank conflicts) and, after one barrier,
// written out as whole rows: 16-byte streaming stores (st.global.cs) of one
// contiguous range, and the table loads carry an L2 evict-last policy, so
// that the output passing through L2 does not evict the tables.
//
// Geometry follows the reference exactly: corner id c = z<<2|y<<1|x, weight
// (w_x * w_y) * w_z on the scaled coordinate's fraction, corners summed in
// the order 0..7, the spatial hash in uint32, a dense index for levels whose
// (R+1)^3 grid fits in T, computed in uint32 as the TPU kernel does and
// clamped into [0, T-1] (JAX's gather clamps an out-of-range index, a CUDA
// load would fault).  Sentinel rows (x < 0, the padding convention of the
// reference) read row 0 with weight 0 and so produce exactly zero.  No
// atomics: two launches write the same bytes.  The wrapper guarantees that
// L*T*F and N*L*F are below 2^31, so every offset fits in 32 bits.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kTile = 32;                 // points per block, one per lane
constexpr uint32_t kPi2 = 2654435761u;
constexpr uint32_t kPi3 = 805459861u;

struct LevelGeom {
    int res[kMaxLevels];
    int dense[kMaxLevels];
};

__host__ __device__ inline int tile_ld(int row_floats, int f) {
    return row_floats + (f < 4 ? f : 4);
}

// F floats into the staging tile at p (aligned to min(F, 4) floats).
template <int F>
__device__ __forceinline__ void store_tile(float* p, const float (&v)[F]) {
    if constexpr (F == 1) {
        p[0] = v[0];
    } else if constexpr (F == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < F; q += 4)
            *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
}

template <int F, class T>
__global__ void __launch_bounds__(kTile * kMaxLevels)
hash_encode_kernel(const float* __restrict__ points,
                   const T* __restrict__ tables,
                   float* __restrict__ out,
                   const LevelGeom geom, int n, int n_levels, int table_size) {
    extern __shared__ __align__(16) float tile[];
    const int lane = threadIdx.x & 31;
    const int l = threadIdx.x >> 5;
    const int row_floats = n_levels * F;
    const int ld = tile_ld(row_floats, F);
    const int p0 = blockIdx.x * kTile;
    const int i = p0 + lane;

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    if (i < n) {
        const float px = points[3 * i + 0];
        const float py = points[3 * i + 1];
        const float pz = points[3 * i + 2];
        const bool valid = px >= 0.0f;

        const int res = geom.res[l];
        const bool dense = geom.dense[l] != 0;
        const float rf = static_cast<float>(res);
        // rounded before the floor and the fraction, as the plain version
        // rounds it (no multiply-add contraction into sx - bx)
        const float sx = __fmul_rn(px, rf), sy = __fmul_rn(py, rf), sz = __fmul_rn(pz, rf);
        const float bx = floorf(sx), by = floorf(sy), bz = floorf(sz);
        const float fx = sx - bx, fy = sy - by, fz = sz - bz;
        const uint32_t ix = static_cast<uint32_t>(static_cast<int>(bx));
        const uint32_t iy = static_cast<uint32_t>(static_cast<int>(by));
        const uint32_t iz = static_cast<uint32_t>(static_cast<int>(bz));

        const uint32_t stride = static_cast<uint32_t>(res) + 1u;
        const uint32_t stride2 = stride * stride;
        const uint32_t mask = static_cast<uint32_t>(table_size - 1);
        const T* __restrict__ tbl =
            tables + static_cast<uint32_t>(l) * static_cast<uint32_t>(table_size) * F;
        const uint64_t policy = table_policy();

        float rows[8][F];
        float w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const uint32_t ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
            const uint32_t cx = ix + ox, cy = iy + oy, cz = iz + oz;
            uint32_t idx;
            if (dense) {
                const int d = static_cast<int>(cx + cy * stride + cz * stride2);
                idx = static_cast<uint32_t>(d < 0 ? 0 : (d > table_size - 1 ? table_size - 1 : d));
            } else {
                idx = (cx ^ cy * kPi2 ^ cz * kPi3) & mask;
            }
            w[c] = ((ox ? fx : 1.0f - fx) * (oy ? fy : 1.0f - fy)) * (oz ? fz : 1.0f - fz);
            if (!valid) {
                idx = 0;
                w[c] = 0.0f;
            }
            load_row<F>(tbl + idx * F, policy, rows[c]);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += w[c] * rows[c][f];
    }

    store_tile<F>(tile + lane * ld + l * F, acc);
    __syncthreads();

    // the tile's rows are one contiguous range of the output, 16-byte
    // aligned (p0 is a multiple of 32)
    const int count = min(kTile, n - p0);
    float* dst = out + p0 * row_floats;
    if (row_floats % 4 == 0) {
        const int q = row_floats / 4;
        for (int e = threadIdx.x; e < count * q; e += blockDim.x) {
            const int r = e / q, c = (e - r * q) * 4;
            const float* s = tile + r * ld + c;
            __stcs(reinterpret_cast<float4*>(dst) + e, make_float4(s[0], s[1], s[2], s[3]));
        }
    } else {
        for (int e = threadIdx.x; e < count * row_floats; e += blockDim.x) {
            const int r = e / row_floats;
            __stcs(dst + e, tile[r * ld + (e - r * row_floats)]);
        }
    }
}

template <int F, class T>
void launch(const float* points, const T* tables, float* out,
            const LevelGeom& geom, int n, int n_levels, int table_size,
            cudaStream_t stream) {
    const int blocks = (n + kTile - 1) / kTile;
    const size_t smem = sizeof(float) * kTile * tile_ld(n_levels * F, F);
    hash_encode_kernel<F, T><<<blocks, kTile * n_levels, smem, stream>>>(
        points, tables, out, geom, n, n_levels, table_size);
}

template <class T>
int launch_features(const float* points, const void* tables, float* out,
                    const LevelGeom& geom, int n, int n_levels, int table_size,
                    int n_features, cudaStream_t s) {
    const T* t = static_cast<const T*>(tables);
    switch (n_features) {
        case 1: launch<1>(points, t, out, geom, n, n_levels, table_size, s); break;
        case 2: launch<2>(points, t, out, geom, n, n_levels, table_size, s); break;
        case 4: launch<4>(points, t, out, geom, n, n_levels, table_size, s); break;
        case 8: launch<8>(points, t, out, geom, n, n_levels, table_size, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points (n, 3), tables (n_levels, table_size, n_features), out
// (n, n_levels * n_features): contiguous, on the current device; points and
// out f32, tables of the element type `table_type` (TableType: f32, bf16,
// f16); tables and out aligned to 16 bytes; n_levels * table_size *
// n_features and n * n_levels * n_features below 2^31 elements.
// resolutions / dense_flags are host arrays of n_levels ints.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int hash_encode_fwd(const float* points, const void* tables,
                               const int* resolutions, const int* dense_flags,
                               float* out, int n, int n_levels, int table_size,
                               int n_features, int table_type, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels || table_size < 1 ||
        (table_size & (table_size - 1)) != 0 || n < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n == 0) return 0;
    LevelGeom geom;
    for (int l = 0; l < n_levels; ++l) {
        geom.res[l] = resolutions[l];
        geom.dense[l] = dense_flags[l];
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return with_table_type(table_type, [&](auto tag) {
        using T = typename decltype(tag)::type;
        return launch_features<T>(points, tables, out, geom, n, n_levels, table_size,
                                  n_features, s);
    });
}
