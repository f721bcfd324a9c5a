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

}  // namespace

// idx (m,) int64 non-decreasing; vals (m, n_features) f32; table
// (table_rows, n_features) f32, updated in place.  Contiguous, on the current
// device.  Returns cudaGetLastError() after the launch (0 on success).
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
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
