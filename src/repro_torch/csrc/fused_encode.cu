// Fused compacted-path encode: one grid's multiresolution hash encode with
// each block's corner reads sorted and deduplicated (the FMU analogue).
//
// Replaces: src/repro/kernels/fused_path/kernel.py:66 fused_encode_pallas
// (body _fused_encode_kernel :36).
//
// What bounds it on the H100: memory.  Each (point, level) pair reads 8
// table rows of F floats at data-dependent addresses and does ~40 flops on
// them.  The TPU kernel held a whole level table in VMEM and sorted the
// block's addresses so that duplicates became adjacent lanes of one gather.
// A level table (2 MiB at T=2^18, F=2) does not fit in shared memory, so
// what carries over is the in-block dedup: the caller feeds Morton-sorted
// points, so the 2048 corner reads of a 256-point block hit far fewer
// distinct rows, and each distinct row is loaded from global memory (L2,
// which holds both table sets) once per (block, level).
//
// Design: one block of 256 threads per (256-point block, level), the Pallas
// grid (n_blocks, L).  Thread t owns point blockIdx.x*256 + t:
//   1. it computes its 8 corner addresses and weights (the geometry of
//      hash_encode.cu: corner id c = z<<2|y<<1|x, weight (w_x*w_y)*w_z with
//      the scaled coordinate rounded first, the uint32 spatial hash, a dense
//      index clamped into [0, T-1]) and writes 8 keys (address << 11 | slot),
//      slot = t*8 + c, to shared memory.  Sentinel rows (x < 0) and rows past
//      N (the reference's sentinel padding) get the invalid key: they read
//      nothing and their output is exactly 0;
//   2. the block sorts the 2048 keys (bitonic, common.cuh);
//   3. the thread at the start of each run of equal addresses loads that row
//      once (__ldg) and writes it to every slot of its run in a (2048, F)
//      shared tile, which puts the rows back in point order;
//   4. each thread sums its 8 corners in corner order 0..7 and writes its
//      F outputs.
// The number of run starts, the distinct rows the block read, is written to
// reads[blockIdx.x * L + level]: the evidence that the reads were
// deduplicated, held against the plain count by chip_smoke.py.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlockPoints = 256;                 // points (= threads) per block
constexpr int kSlots = kBlockPoints * 8;          // corner reads per (block, level)
constexpr int kSlotBits = 11;                     // log2(kSlots)
constexpr unsigned long long kSlotMask = (1ull << kSlotBits) - 1;
constexpr unsigned long long kInvalid = ~0ull;

struct LevelGeom {
    int res[kMaxLevels];
    int dense[kMaxLevels];
};

template <int F>
size_t smem_bytes() {
    return kSlots * sizeof(unsigned long long) + static_cast<size_t>(kSlots) * F * sizeof(float);
}

template <int F>
__global__ void __launch_bounds__(kBlockPoints)
fused_encode_kernel(const float* __restrict__ points, const float* __restrict__ tables,
                    float* __restrict__ out, int* __restrict__ reads,
                    const LevelGeom geom, int n, int n_levels, int table_size) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
    float* feats = reinterpret_cast<float*>(keys + kSlots);   // (kSlots, F), slot order
    __shared__ int distinct;

    const int t = threadIdx.x;
    const int i = blockIdx.x * kBlockPoints + t;
    const int l = blockIdx.y;
    if (t == 0) distinct = 0;

    // 1. this point's corners: keys to shared memory, weights in registers
    float px = -1.0f, py = 0.0f, pz = 0.0f;
    if (i < n) {
        px = points[3 * i + 0];
        py = points[3 * i + 1];
        pz = points[3 * i + 2];
    }
    const bool valid = i < n && px >= 0.0f;
    const int res = geom.res[l];
    const bool dense = geom.dense[l] != 0;
    const float rf = static_cast<float>(res);
    const float sx = __fmul_rn(px, rf), sy = __fmul_rn(py, rf), sz = __fmul_rn(pz, rf);
    const float bx = floorf(sx), by = floorf(sy), bz = floorf(sz);
    const float fx = __fsub_rn(sx, bx), fy = __fsub_rn(sy, by), fz = __fsub_rn(sz, bz);
    const int ix = static_cast<int>(bx), iy = static_cast<int>(by), iz = static_cast<int>(bz);
    const long long stride = static_cast<long long>(res) + 1;
    const uint32_t mask = static_cast<uint32_t>(table_size - 1);

    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
        const float wx = ox ? fx : __fsub_rn(1.0f, fx);
        const float wy = oy ? fy : __fsub_rn(1.0f, fy);
        const float wz = oz ? fz : __fsub_rn(1.0f, fz);
        w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
        unsigned long long key = kInvalid;
        if (valid) {
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
            key = (static_cast<unsigned long long>(idx) << kSlotBits) |
                  static_cast<unsigned long long>(t * 8 + c);
        }
        keys[t * 8 + c] = key;
    }
    __syncthreads();

    // 2. sort the block's reads: equal addresses become adjacent runs
    bitonic_sort<kSlots>(keys);

    // 3. one load per distinct address, propagated along its run
    const float* __restrict__ tbl = tables + static_cast<size_t>(l) * table_size * F;
    int mine = 0;
    for (int s = t; s < kSlots; s += kBlockPoints) {
        const unsigned long long key = keys[s];
        if (key == kInvalid) continue;               // invalid keys sort last
        const unsigned long long addr = key >> kSlotBits;
        if (s > 0 && (keys[s - 1] >> kSlotBits) == addr) continue;
        ++mine;
        float row[F];
        const float* src = tbl + addr * F;
        if constexpr (F == 2) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(src));
            row[0] = v.x;
            row[1] = v.y;
        } else if constexpr (F == 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src));
            row[0] = v.x;
            row[1] = v.y;
            row[2] = v.z;
            row[3] = v.w;
        } else {
#pragma unroll
            for (int f = 0; f < F; ++f) row[f] = __ldg(src + f);
        }
        for (int r = s; r < kSlots; ++r) {
            const unsigned long long k = keys[r];
            if (k == kInvalid || (k >> kSlotBits) != addr) break;
            float* dst = feats + static_cast<size_t>(k & kSlotMask) * F;
#pragma unroll
            for (int f = 0; f < F; ++f) dst[f] = row[f];
        }
    }
    if (mine) atomicAdd(&distinct, mine);
    __syncthreads();

    // 4. the weighted sum over the 8 corners, in corner order
    if (i < n) {
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        if (valid) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float* v = feats + static_cast<size_t>(t * 8 + c) * F;
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f] += w[c] * v[f];
            }
        }
        float* o = out + static_cast<size_t>(i) * n_levels * F + static_cast<size_t>(l) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) o[f] = acc[f];
    }
    if (t == 0) reads[static_cast<size_t>(blockIdx.x) * n_levels + l] = distinct;
}

template <int F>
int launch(const float* points, const float* tables, float* out, int* reads,
           const LevelGeom& geom, int n, int n_levels, int table_size, cudaStream_t stream) {
    const size_t smem = smem_bytes<F>();
    cudaError_t err = cudaFuncSetAttribute(fused_encode_kernel<F>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kBlockPoints - 1) / kBlockPoints, n_levels);
    fused_encode_kernel<F><<<grid, kBlockPoints, smem, stream>>>(
        points, tables, out, reads, geom, n, n_levels, table_size);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points (n, 3), tables (n_levels, table_size, n_features), out
// (n, n_levels * n_features): f32, contiguous, on the current device; reads
// (ceil(n / 256), n_levels) int32.  resolutions / dense_flags are host
// arrays of n_levels ints.  table_size is a power of two below 2^31.
// Returns the CUDA status after the launch (0 on success).
extern "C" int fused_encode_fwd(const float* points, const float* tables,
                                const int* resolutions, const int* dense_flags,
                                float* out, int* reads, int n, int n_levels,
                                int table_size, int n_features, void* stream) {
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
        case 1: return launch<1>(points, tables, out, reads, geom, n, n_levels, table_size, s);
        case 2: return launch<2>(points, tables, out, reads, geom, n, n_levels, table_size, s);
        case 4: return launch<4>(points, tables, out, reads, geom, n, n_levels, table_size, s);
        case 8: return launch<8>(points, tables, out, reads, geom, n, n_levels, table_size, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
