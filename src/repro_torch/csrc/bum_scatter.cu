// BUM merged scatter-add: commit an address-sorted gradient stream into a
// table, one write per run of equal addresses (paper section 4.5, the
// Back-propagation Update Merger).
//
// Replaces: src/repro/kernels/grid_update/kernel.py:69 bum_scatter_pallas
// (body _bum_kernel :38).
//
// What bounds it on the H100: memory.  Each stream entry is read once (an
// 8-byte address and F floats) and each touched table row is read and
// written once, for one add per entry -- far below the card's 20 flop/byte
// balance point.
//
// Arithmetic: the TPU kernel walked the sorted stream in blocks, one after
// another, summing runs with a one-hot matmul and letting later blocks add
// onto what earlier ones wrote -- sound only because a TPU grid runs in
// order.  Here blocks run in parallel, so no two threads may write one row:
// only the thread that owns a run start (idx[i] != idx[i-1]) writes, once.
// It sums its run from zero in stream order and adds the sum to its row.
// Every address has exactly one run start, so there is no race and no float
// atomic, and the result is the same bits on every run: the sum of each run
// is the reference's segment_sum in stream order.  Adds use __fadd_rn so
// the compiler cannot reassociate them.  Entries outside [0, T) -- the
// spill row T that pads a stream -- are dropped.
//
// Design: a tiled stream.  A block takes a tile of kTile consecutive
// entries and copies its addresses and values into shared memory with
// cp.async, 16 bytes a copy (4 where the stream is not 16-byte aligned or
// the tile is the ragged last one), coalesced and all in flight together.
// The tile's run starts are found in shared memory, one warp ballot per 32
// entries (the first entry compares with the address before the tile), and
// compacted in stream order into a list, so that the run ends are known (the
// next start) and the lanes of a warp take consecutive runs.  Each run
// start then folds its run from shared memory with a known trip count: no
// address compare waits inside the fold.  Entries before a tile's first run
// start belong to a run of an earlier tile and are skipped; the one run
// that may leave the tile (the last) is finished by its start from device
// memory, kRunAhead entries a step so that their loads are in flight
// together.  The grid is one block per tile, about five blocks an SM at F =
// 2 (a persistent grid with double-buffered tiles was slower on every
// stream of the training paths, PERF.md).
//
// Wide rows (any F outside {1, 2, 4, 8}: the LM's vocab-embedding gradient,
// one row of F = d_model floats a token, 64 to 7168).  A row no longer fits
// a thread's registers, so a row is cut into chunks of kWideThreads vectors
// of 4 floats where the rows are 16-byte aligned (else 1 float), one chunk
// a block along the grid's y axis, and a block walks the runs that start in
// its tile of kWideTile entries one after another over its chunk.  (One
// block a tile spanning the whole row ran 128 blocks for 1024 tokens and
// trailed `index_add_` by 38% at F = 7168, PERF.md.)  Run
// starts are found as above (the tile's first entry against the entry
// before it); the last run's end is found by one warp's ballots over the
// addresses past the tile, so that every run is walked with a known trip
// count, its loads kWideAhead entries at a time in flight together.  Each
// thread sums its columns of the run from zero in stream order (__fadd_rn)
// and adds the sum to the row once: the same bits as the narrow kernel and
// the plain merge, with no atomics.
#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                 // entries per tile
constexpr int kRounds = kTile / kThreads;   // ballots per warp and tile
constexpr int kRunAhead = 8;                // device-memory entries a step, past the tile

// Shared memory of the tile's stream: the addresses, then F floats an entry.
template <int F>
__host__ __device__ constexpr size_t tile_bytes() {
    return kTile * (sizeof(int64_t) + F * sizeof(float));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
bum_scatter_kernel(const int64_t* __restrict__ idx, const float* __restrict__ vals,
                   float* __restrict__ table, int64_t m, int64_t table_rows, bool vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int s_start[kTile + 1];          // the tile's run starts, in stream order
    __shared__ int s_count[kRounds * kWarps];   // run starts per 32-entry chunk, then offsets
    __shared__ int s_runs;
    int64_t* ti = reinterpret_cast<int64_t*>(smem_raw);
    float* tv = reinterpret_cast<float*>(smem_raw + kTile * sizeof(int64_t));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    const int n = static_cast<int>(m - base < kTile ? m - base : kTile);

    // the tile's addresses and values into shared memory, all in flight
    // together; the address before the tile read meanwhile
    {
        float* di = reinterpret_cast<float*>(ti);
        const float* si = reinterpret_cast<const float*>(idx + base);
        const float* sv = vals + base * F;
        if (vec && n == kTile) {
            for (int e = threadIdx.x; e < kTile / 2; e += kThreads)
                mlp_tile::cp_async<16>(di + 4 * e, si + 4 * e, true);
            for (int e = threadIdx.x; e < kTile * F / 4; e += kThreads)
                mlp_tile::cp_async<16>(tv + 4 * e, sv + 4 * e, true);
        } else {
            for (int e = threadIdx.x; e < 2 * n; e += kThreads)
                mlp_tile::cp_async<4>(di + e, si + e, true);
            for (int e = threadIdx.x; e < n * F; e += kThreads)
                mlp_tile::cp_async<4>(tv + e, sv + e, true);
        }
        mlp_tile::commit();
    }
    const long long* idx_ll = reinterpret_cast<const long long*>(idx);
    const int64_t before = (base > 0 && threadIdx.x == 0) ? __ldg(idx_ll + base - 1) : 0;
    mlp_tile::wait<0>();
    __syncthreads();

    // run starts: entry e = r * kThreads + threadIdx.x, chunk r * kWarps + warp
    uint32_t mask[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const int e = r * kThreads + threadIdx.x;
        bool start = false;
        if (e < n) {
            const int64_t a = ti[e];
            start = e > 0 ? a != ti[e - 1] : (base == 0 || a != before);
        }
        mask[r] = __ballot_sync(0xffffffffu, start);
        if (lane == 0) s_count[r * kWarps + warp] = __popc(mask[r]);
    }
    __syncthreads();
    if (warp == 0) {            // exclusive scan of the 64 chunk counts, 2 per lane
        const int c0 = s_count[2 * lane], c1 = s_count[2 * lane + 1];
        int incl = c0 + c1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
        }
        const int excl = incl - c0 - c1;
        s_count[2 * lane] = excl;
        s_count[2 * lane + 1] = excl + c0;
        if (lane == 31) s_runs = incl;
    }
    __syncthreads();
    const uint32_t below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
        if (mask[r] >> lane & 1u)
            s_start[s_count[r * kWarps + warp] + __popc(mask[r] & below)] =
                r * kThreads + threadIdx.x;
    const int runs = s_runs;
    if (threadIdx.x == 0) s_start[runs] = n;
    __syncthreads();

    // folds: run k spans [s_start[k], s_start[k + 1]) of the tile
    for (int k = threadIdx.x; k < runs; k += kThreads) {
        const int s = s_start[k], end = s_start[k + 1];
        const int64_t a = ti[s];
        if (a < 0 || a >= table_rows) continue;         // spill row: dropped
        float sum[F];
#pragma unroll
        for (int f = 0; f < F; ++f) sum[f] = 0.0f;
        for (int j = s; j < end; ++j)
#pragma unroll
            for (int f = 0; f < F; ++f) sum[f] = __fadd_rn(sum[f], tv[j * F + f]);
        if (end == n) {             // the run may go on past the tile
            bool more = true;
            for (int64_t j0 = base + n; more && j0 < m; j0 += kRunAhead) {
                int64_t ahead[kRunAhead];
                float v[kRunAhead][F];
#pragma unroll
                for (int u = 0; u < kRunAhead; ++u) {
                    const bool in = j0 + u < m;
                    ahead[u] = in ? __ldg(idx_ll + j0 + u) : a + 1;
#pragma unroll
                    for (int f = 0; f < F; ++f)
                        v[u][f] = in ? __ldg(vals + (j0 + u) * F + f) : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < kRunAhead; ++u) {
                    more = more && ahead[u] == a;
                    if (more)
#pragma unroll
                        for (int f = 0; f < F; ++f) sum[f] = __fadd_rn(sum[f], v[u][f]);
                }
            }
        }
        float* row = table + a * F;
#pragma unroll
        for (int f = 0; f < F; ++f) row[f] = __fadd_rn(row[f], sum[f]);
    }
}

template <int F>
int launch(const int64_t* idx, const float* vals, float* table, int64_t m,
           int64_t table_rows, cudaStream_t stream) {
    const int64_t blocks = (m + kTile - 1) / kTile;
    const bool vec =
        (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
    cudaFuncSetAttribute(bum_scatter_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(tile_bytes<F>()));
    bum_scatter_kernel<F><<<static_cast<unsigned>(blocks), kThreads, tile_bytes<F>(), stream>>>(
        idx, vals, table, m, table_rows, vec);
    return static_cast<int>(cudaGetLastError());
}

constexpr int kWideThreads = 128;
constexpr int kWideTile = 8;                // entries per block
constexpr int kWideAhead = 4;               // rows of a run in flight together

template <int V>
struct Vec {
    float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
    Vec<V> r;
    if constexpr (V == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = x.x;
        r.v[1] = x.y;
        r.v[2] = x.z;
        r.v[3] = x.w;
    } else {
        r.v[0] = __ldg(p);
    }
    return r;
}

template <int V>
__device__ __forceinline__ void add_vec(float (&acc)[V], const Vec<V>& x) {
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], x.v[q]);
}

// V floats a thread: the row is F / V vectors, chunk blockIdx.y of them
// spread over the block.
template <int V>
__global__ void __launch_bounds__(kWideThreads)
bum_scatter_wide_kernel(const int64_t* __restrict__ idx, const float* __restrict__ vals,
                        float* __restrict__ table, int64_t m, int64_t table_rows, int f) {
    __shared__ long long s_idx[kWideTile];
    __shared__ int s_start[kWideTile + 1];      // run starts in the tile, in stream order
    __shared__ int s_runs;
    __shared__ long long s_last_end;            // where the tile's last run ends
    const long long* idx_ll = reinterpret_cast<const long long*>(idx);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kWideTile;
    const int n = static_cast<int>(m - base < kWideTile ? m - base : kWideTile);
    if (threadIdx.x < n) s_idx[threadIdx.x] = __ldg(idx_ll + base + threadIdx.x);
    const long long before = base > 0 ? __ldg(idx_ll + base - 1) : 0;
    __syncthreads();
    if (threadIdx.x == 0) {
        int runs = 0;
        for (int e = 0; e < n; ++e)
            if (e > 0 ? s_idx[e] != s_idx[e - 1] : (base == 0 || s_idx[0] != before))
                s_start[runs++] = e;
        s_runs = runs;
    }
    __syncthreads();
    const int runs = s_runs;
    if (runs == 0) return;                      // the tile lies inside an earlier run
    if (warp == 0) {                            // the last run's end, past the tile
        const long long a = s_idx[s_start[runs - 1]];
        int64_t j = base + n;
        while (true) {
            const int64_t e = j + lane;
            const bool other = e >= m || __ldg(idx_ll + e) != a;
            const unsigned hit = __ballot_sync(0xffffffffu, other);
            if (hit) {
                j += __ffs(hit) - 1;
                break;
            }
            j += 32;
        }
        if (lane == 0) s_last_end = j;
    }
    __syncthreads();
    const int nv = f / V;
    const int c0 = blockIdx.y * blockDim.x + threadIdx.x;
    const int c_step = gridDim.y * blockDim.x;
    for (int r = 0; r < runs; ++r) {
        const long long a = s_idx[s_start[r]];
        if (a < 0 || a >= table_rows) continue;             // spill row: dropped
        const int64_t s = base + s_start[r];
        const int64_t end = r + 1 < runs ? base + s_start[r + 1] : s_last_end;
        for (int c = c0; c < nv; c += c_step) {
            const float* src = vals + s * f + c * V;
            float acc[V];
#pragma unroll
            for (int q = 0; q < V; ++q) acc[q] = 0.0f;
            int64_t j = s;
            for (; j + kWideAhead <= end; j += kWideAhead, src += kWideAhead * f) {
                Vec<V> x[kWideAhead];
#pragma unroll
                for (int u = 0; u < kWideAhead; ++u) x[u] = load_vec<V>(src + u * f);
#pragma unroll
                for (int u = 0; u < kWideAhead; ++u) add_vec<V>(acc, x[u]);
            }
            for (; j < end; ++j, src += f) add_vec<V>(acc, load_vec<V>(src));
            float* row = table + a * f + c * V;
#pragma unroll
            for (int q = 0; q < V; ++q) row[q] = __fadd_rn(row[q], acc[q]);
        }
    }
}

int launch_wide(const int64_t* idx, const float* vals, float* table, int64_t m,
                int64_t table_rows, int f, cudaStream_t stream) {
    const bool vec = f % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(table)) % 16 == 0;
    const int nv = vec ? f / 4 : f;
    const int threads = nv >= kWideThreads ? kWideThreads : (nv + 31) / 32 * 32;
    const int64_t blocks = (m + kWideTile - 1) / kWideTile;
    const int chunks = (nv + threads - 1) / threads;
    if (blocks > 0x7fffffff || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
    if (vec)
        bum_scatter_wide_kernel<4><<<grid, threads, 0, stream>>>(idx, vals, table, m,
                                                                 table_rows, f);
    else
        bum_scatter_wide_kernel<1><<<grid, threads, 0, stream>>>(idx, vals, table, m,
                                                                 table_rows, f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// idx (m,) int64 non-decreasing; vals (m, n_features) f32; table
// (table_rows, n_features) f32, updated in place; n_features >= 1 (1, 2, 4
// and 8 by the tiled kernel, any other by the wide one).  Contiguous, on the
// current device.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int bum_scatter_commit(const int64_t* idx, const float* vals, float* table,
                                  int64_t m, int64_t table_rows, int n_features,
                                  void* stream) {
    if (m < 0 || table_rows < 0 || m / kTile >= 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_features) {
        case 1: return launch<1>(idx, vals, table, m, table_rows, s);
        case 2: return launch<2>(idx, vals, table, m, table_rows, s);
        case 4: return launch<4>(idx, vals, table, m, table_rows, s);
        case 8: return launch<8>(idx, vals, table, m, table_rows, s);
        default:
            if (n_features < 1) return static_cast<int>(cudaErrorInvalidValue);
            return launch_wide(idx, vals, table, m, table_rows, n_features, s);
    }
}
