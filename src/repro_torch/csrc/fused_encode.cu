// Fused compacted-path encode: one grid's multiresolution hash encode with
// each block's corner reads deduplicated (the FMU analogue).
//
// Replaces: src/repro/kernels/fused_path/kernel.py:66 fused_encode_pallas
// (body _fused_encode_kernel :36).
//
// What bounds it on the H100: the gathers.  Each (point, level) pair reads 8
// table rows of F floats at data-dependent addresses and does ~40 flops on
// them.  The TPU kernel held a whole level table in VMEM and sorted the
// block's addresses so that duplicates became adjacent lanes of one gather.
// A level table (2 MiB at T=2^18, F=2) does not fit in shared memory, but
// both table sets fit in the 50 MB L2; what carries over is the in-block
// dedup: the caller feeds Morton-sorted points, so the 2048 corner reads of
// a 256-point block hit far fewer distinct rows, and each distinct row is
// loaded once per (block, level).
//
// Design: a block of 256 threads owns a 256-point block (the reference's)
// and G = min(4, 8 / F) consecutive levels, one after another; thread t owns
// point blockIdx.x*256 + t, and its corner c is the block's read id t*8 + c.
// The dedup elects one reader per distinct row address with O(1)
// shared-memory operations a read, in rounds, where a sort of the 2048
// addresses took 66 barrier-separated stages:
//   1. each thread computes its 8 corner addresses and weights (the geometry
//      of hash_encode.cu: corner id c = z<<2|y<<1|x, weight (w_x*w_y)*w_z
//      with the scaled coordinate rounded first, the uint32 spatial hash, a
//      dense index clamped into [0, T-1]).  Sentinel rows (x < 0) and rows
//      past N (the reference's sentinel padding) have no corners: they read
//      nothing and their output is exactly 0;
//   2. a round: every read not yet placed hashes its address (a hash that
//      changes every round) into a table of 4096 slots and atomicMax-es
//      (round << 16 | read id) into its slot -- the largest id wins, whatever
//      the order; after a barrier each read looks up its slot's winner, and
//      if the winner's address is its own, that winner is its row's reader.
//      Reads of one address share a slot and are placed together; an
//      address that lost its slot to another tries again in the next round
//      (at most 2048 addresses in 4096 slots: about one in five lose the
//      first round, one in a hundred the second).  The readers are the
//      distinct rows, so their count is the number of rows the block read,
//      exact by construction.  Tables of 8192 and 16384 slots were slower
//      (fewer blocks fit an SM), and so was an open-addressing hash set
//      with atomicCAS inserts, whose probe loops hold each warp to its
//      longest;
//   3. each reader loads its row with one vector load (L2 evict-last, as in
//      hash_encode.cu; a 2-byte table's row, bf16 or f16, in one load of
//      its 2F bytes, widened to f32 in registers) into the payload slot of
//      its read id, as f32;
//   4. after one barrier every thread reads its 8 corners from the payload
//      and sums them in corner order 0..7, into a shared (256, G*F) tile.
// No atomic's order reaches the output: a winner is the largest id, and the
// row it loads is the same whoever loads it.
// The tile leaves as the points' G*F-float row segments (32 bytes at F=2:
// whole sectors, 16-byte stores), so every output byte is stored once, with
// no partial sectors.  Storing whole L*F rows would need one block to cover
// all 16 levels: 128 blocks for 32,768 points on 132 SMs.  The count is
// written to reads[blockIdx.x * L + level], the evidence that the reads were
// deduplicated, held against the plain count by chip_smoke.py.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kBlockPoints = 256;                 // points (= threads) per block
constexpr int kReads = kBlockPoints * 8;          // corner reads per (block, level)
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;            // election slots, 2 per read
constexpr uint32_t kNoRow = 0xffffffffu;          // no row (table sizes < 2^31)

struct LevelGeom {
    int res[kMaxLevels];
    int dense[kMaxLevels];
};

template <int F>
__host__ __device__ constexpr int levels_per_block() {
    return F >= 8 ? 1 : (F == 4 ? 2 : 4);
}

// row stride of the output tile in floats; as in hash_encode.cu, the pad
// keeps a warp's stores free of bank conflicts
template <int F>
__host__ __device__ constexpr int tile_ld() {
    return levels_per_block<F>() * F + (F < 4 ? F : 4);
}

template <int F>
constexpr size_t smem_bytes() {
    return sizeof(uint32_t) * kSlots               // election slots
         + sizeof(uint32_t) * kReads               // each read's row address
         + sizeof(float) * kReads * F              // payload: rows by reader id
         + sizeof(float) * kBlockPoints * tile_ld<F>();
}

// the slot of a row address in election round `round`
__device__ __forceinline__ uint32_t slot_of(uint32_t addr, uint32_t round) {
    uint32_t h = (addr ^ (round * 0x9e3779b9u)) * 0x85ebca6bu;
    h ^= h >> 15;
    return (h * 0xc2b2ae35u) >> (32 - kSlotBits);
}

template <int F, class T>
__global__ void __launch_bounds__(kBlockPoints)
fused_encode_kernel(const float* __restrict__ points, const T* __restrict__ tables,
                    float* __restrict__ out, int* __restrict__ reads,
                    const LevelGeom geom, int n, int n_levels, int table_size) {
    constexpr int G = levels_per_block<F>();
    constexpr int ld = tile_ld<F>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* payload = reinterpret_cast<float*>(smem_raw);                  // (kReads, F)
    float* tile = payload + kReads * F;                                   // (256, ld)
    uint32_t* slots = reinterpret_cast<uint32_t*>(tile + kBlockPoints * ld);
    uint32_t* read_addr = slots + kSlots;                                 // (kReads,)
    __shared__ int rows_read;

    const int t = threadIdx.x;
    const int i = blockIdx.x * kBlockPoints + t;
    const int l0 = blockIdx.y * G;
    const int l1 = min(n_levels, l0 + G);

    for (int s = t; s < kSlots; s += kBlockPoints) slots[s] = 0;
    if (t == 0) rows_read = 0;
    float px = -1.0f, py = 0.0f, pz = 0.0f;
    if (i < n) {
        px = points[3 * i + 0];
        py = points[3 * i + 1];
        pz = points[3 * i + 2];
    }
    const bool valid = i < n && px >= 0.0f;
    const uint32_t mask = static_cast<uint32_t>(table_size - 1);
    const uint64_t policy = table_policy();
    uint32_t round = 0;                               // election rounds so far

    for (int l = l0; l < l1; ++l) {
        // 1. this point's corners
        const int res = geom.res[l];
        const bool dense = geom.dense[l] != 0;
        const float rf = static_cast<float>(res);
        const float sx = __fmul_rn(px, rf), sy = __fmul_rn(py, rf), sz = __fmul_rn(pz, rf);
        const float bx = floorf(sx), by = floorf(sy), bz = floorf(sz);
        const float fx = __fsub_rn(sx, bx), fy = __fsub_rn(sy, by), fz = __fsub_rn(sz, bz);
        const int ix = static_cast<int>(bx), iy = static_cast<int>(by), iz = static_cast<int>(bz);
        const long long stride = static_cast<long long>(res) + 1;
        uint32_t addr[8];
        float w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
            const float wx = ox ? fx : __fsub_rn(1.0f, fx);
            const float wy = oy ? fy : __fsub_rn(1.0f, fy);
            const float wz = oz ? fz : __fsub_rn(1.0f, fz);
            w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
            addr[c] = kNoRow;
            if (valid) {
                const int cx = ix + ox, cy = iy + oy, cz = iz + oz;
                if (dense) {
                    long long idx = cx + cy * stride + cz * stride * stride;
                    idx = idx < 0 ? 0 : (idx > table_size - 1 ? table_size - 1 : idx);
                    addr[c] = static_cast<uint32_t>(idx);
                } else {
                    addr[c] = (static_cast<uint32_t>(cx) * 1u
                               ^ static_cast<uint32_t>(cy) * 2654435761u
                               ^ static_cast<uint32_t>(cz) * 805459861u) & mask;
                }
            }
            read_addr[t * 8 + c] = addr[c];
        }

        // 2. elect one reader per distinct address: reader[c] is the read id
        // whose thread loads corner c's row
        unsigned pending = valid ? 0xffu : 0u;
        int reader[8];
        uint32_t slot[8];
        while (__syncthreads_or(pending)) {          // also: last round's lookups done
            ++round;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                if (pending >> c & 1) {
                    slot[c] = slot_of(addr[c], round);
                    atomicMax(&slots[slot[c]], round << 16 | static_cast<uint32_t>(t * 8 + c));
                }
            }
            __syncthreads();
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                if (pending >> c & 1) {
                    const int winner = static_cast<int>(slots[slot[c]] & 0xffffu);
                    if (read_addr[winner] == addr[c]) {
                        reader[c] = winner;
                        pending &= ~(1u << c);
                    }
                }
            }
        }

        // 3. the readers load their rows into the payload
        float row[8][F];
        unsigned mine = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            if (valid && reader[c] == t * 8 + c) {
                mine |= 1u << c;
                load_row<F>(tables + (static_cast<size_t>(l) * table_size + addr[c]) * F,
                            policy, row[c]);
            }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
            if (mine >> c & 1)
#pragma unroll
                for (int f = 0; f < F; ++f) payload[(t * 8 + c) * F + f] = row[c][f];
        const int n_mine = __reduce_add_sync(0xffffffffu, __popc(mine));
        if ((t & 31) == 0 && n_mine) atomicAdd(&rows_read, n_mine);
        __syncthreads();

        // 4. the weighted sum over the 8 corners, in corner order
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        if (valid) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float* v = payload + reader[c] * F;
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f] += w[c] * v[f];
            }
        }
#pragma unroll
        for (int f = 0; f < F; ++f) tile[t * ld + (l - l0) * F + f] = acc[f];
        if (t == 0) {
            reads[static_cast<size_t>(blockIdx.x) * n_levels + l] = rows_read;
            rows_read = 0;
        }
        // the next level's first __syncthreads_or orders these reads before
        // its writes to read_addr and the payload
    }
    __syncthreads();

    // the block's points' segments [l0*F, l1*F) of their output rows
    const int p0 = blockIdx.x * kBlockPoints;
    const int count = min(kBlockPoints, n - p0);
    const int seg = (l1 - l0) * F;
    const int row_floats = n_levels * F;
    float* dst = out + static_cast<size_t>(p0) * row_floats + l0 * F;
    if (seg % 4 == 0 && row_floats % 4 == 0) {
        const int q = seg / 4;
        for (int e = t; e < count * q; e += kBlockPoints) {
            const int r = e / q, c = (e - r * q) * 4;
            const float* s = tile + r * ld + c;
            *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * row_floats + c) =
                make_float4(s[0], s[1], s[2], s[3]);
        }
    } else {
        for (int e = t; e < count * seg; e += kBlockPoints) {
            const int r = e / seg, c = e - r * seg;
            dst[static_cast<size_t>(r) * row_floats + c] = tile[r * ld + c];
        }
    }
}

template <int F, class T>
int launch(const float* points, const T* tables, float* out, int* reads,
           const LevelGeom& geom, int n, int n_levels, int table_size, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<F>();
    cudaError_t err = cudaFuncSetAttribute(fused_encode_kernel<F, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int G = levels_per_block<F>();
    const dim3 grid((n + kBlockPoints - 1) / kBlockPoints, (n_levels + G - 1) / G);
    fused_encode_kernel<F, T><<<grid, kBlockPoints, smem, stream>>>(
        points, tables, out, reads, geom, n, n_levels, table_size);
    return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_features(const float* points, const void* tables, float* out, int* reads,
                    const LevelGeom& geom, int n, int n_levels, int table_size, int n_features,
                    cudaStream_t s) {
    const T* t = static_cast<const T*>(tables);
    switch (n_features) {
        case 1: return launch<1>(points, t, out, reads, geom, n, n_levels, table_size, s);
        case 2: return launch<2>(points, t, out, reads, geom, n, n_levels, table_size, s);
        case 4: return launch<4>(points, t, out, reads, geom, n, n_levels, table_size, s);
        case 8: return launch<8>(points, t, out, reads, geom, n, n_levels, table_size, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// points (n, 3), tables (n_levels, table_size, n_features), out
// (n, n_levels * n_features): contiguous, on the current device; points and
// out f32, tables of the element type `table_type` (TableType: f32, bf16,
// f16); tables and out aligned to 16 bytes; reads (ceil(n / 256), n_levels)
// int32.  resolutions / dense_flags are host arrays of n_levels ints.
// table_size is a power of two below 2^31.  Returns the CUDA status after
// the launch (0 on success).
extern "C" int fused_encode_fwd(const float* points, const void* tables,
                                const int* resolutions, const int* dense_flags,
                                float* out, int* reads, int n, int n_levels,
                                int table_size, int n_features, int table_type,
                                void* stream) {
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
    return with_table_type(table_type, [&](auto tag) {
        using T = typename decltype(tag)::type;
        return launch_features<T>(points, tables, out, reads, geom, n, n_levels, table_size,
                                  n_features, s);
    });
}
