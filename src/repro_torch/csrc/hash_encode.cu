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
// gathers are served from L2, not HBM.
//
// Design: one thread per (point, level).  blockIdx.y is the level, so all
// gathers of a block hit one level table, and the blocks of one level share
// its L2 lines.  The eight corners are read through the read-only data path
// (__ldg).  Geometry follows the reference exactly: corner id c = z<<2|y<<1|x,
// weight (w_x * w_y) * w_z, the spatial hash in uint32, a dense index for
// levels whose (R+1)^3 grid fits in T.  The dense index is clamped into
// [0, T-1]: JAX's gather clamps an out-of-range index, a CUDA load would
// fault.  Sentinel rows (x < 0, the padding convention of the reference)
// read row 0 with weight 0 and so produce exactly zero.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct LevelGeom {
    int res[kMaxLevels];
    int dense[kMaxLevels];
};

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ points,
                   const float* __restrict__ tables,
                   float* __restrict__ out,
                   const LevelGeom geom, int n, int n_levels, int table_size) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int l = blockIdx.y;
    if (i >= n) return;

    const float px = points[3 * i + 0];
    const float py = points[3 * i + 1];
    const float pz = points[3 * i + 2];
    const bool valid = px >= 0.0f;

    const int res = geom.res[l];
    const bool dense = geom.dense[l] != 0;
    const float rf = static_cast<float>(res);
    const float sx = px * rf, sy = py * rf, sz = pz * rf;
    const float bx = floorf(sx), by = floorf(sy), bz = floorf(sz);
    const float fx = sx - bx, fy = sy - by, fz = sz - bz;
    const int ix = static_cast<int>(bx);
    const int iy = static_cast<int>(by);
    const int iz = static_cast<int>(bz);

    const long long stride = static_cast<long long>(res) + 1;
    const uint32_t mask = static_cast<uint32_t>(table_size - 1);
    const float* __restrict__ tbl =
        tables + static_cast<size_t>(l) * table_size * F;

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
        const int cx = ix + ox, cy = iy + oy, cz = iz + oz;
        long long idx;
        if (dense) {
            idx = cx + cy * stride + cz * stride * stride;
            idx = idx < 0 ? 0 : (idx > table_size - 1 ? table_size - 1 : idx);
        } else {
            const uint32_t h = static_cast<uint32_t>(cx) * 1u
                             ^ static_cast<uint32_t>(cy) * 2654435761u
                             ^ static_cast<uint32_t>(cz) * 805459861u;
            idx = static_cast<long long>(h & mask);
        }
        float w = ((ox ? fx : 1.0f - fx) * (oy ? fy : 1.0f - fy))
                * (oz ? fz : 1.0f - fz);
        if (!valid) {
            idx = 0;
            w = 0.0f;
        }
        const float* row = tbl + idx * F;
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += w * __ldg(row + f);
    }

    float* o = out + static_cast<size_t>(i) * n_levels * F + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
}

template <int F>
void launch(const float* points, const float* tables, float* out,
            const LevelGeom& geom, int n, int n_levels, int table_size,
            cudaStream_t stream) {
    const dim3 grid((n + kThreads - 1) / kThreads, n_levels);
    hash_encode_kernel<F><<<grid, kThreads, 0, stream>>>(
        points, tables, out, geom, n, n_levels, table_size);
}

}  // namespace

// points (n, 3), tables (n_levels, table_size, n_features), out
// (n, n_levels * n_features): f32, contiguous, on the current device.
// resolutions / dense_flags are host arrays of n_levels ints.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hash_encode_fwd(const float* points, const float* tables,
                               const int* resolutions, const int* dense_flags,
                               float* out, int n, int n_levels, int table_size,
                               int n_features, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels || table_size < 1 ||
        (table_size & (table_size - 1)) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n == 0) return 0;
    LevelGeom geom;
    for (int l = 0; l < n_levels; ++l) {
        geom.res[l] = resolutions[l];
        geom.dense[l] = dense_flags[l];
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_features) {
        case 1: launch<1>(points, tables, out, geom, n, n_levels, table_size, s); break;
        case 2: launch<2>(points, tables, out, geom, n, n_levels, table_size, s); break;
        case 4: launch<4>(points, tables, out, geom, n, n_levels, table_size, s); break;
        case 8: launch<8>(points, tables, out, geom, n, n_levels, table_size, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
