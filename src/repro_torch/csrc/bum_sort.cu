// Stable sort of a table-gradient stream by address, values carried: the
// ordering half of the BUM commit (paper section 4.5), which bum_scatter.cu
// then merges run by run.
//
// Replaces: the in-block argsort of the commit inside
// src/repro/kernels/fused_step/kernel.py:266 fused_step_bwd_pallas (body
// `commit` :246, jnp.argsort then segment_sum per level).  The same sort
// serves the dense hash-encode backward's stream and the fused encode's
// backward, which the reference sorts with jnp.argsort outside Pallas.
//
// What bounds it on the H100: memory.  Each pass reads the stream (a key and
// F floats per entry) and writes it back in a new order, with a few integer
// operations per entry.  The TPU kernel sorted each block's few hundred
// entries inside the block and merged per level.  Here one stream holds up to
// millions of entries whose addresses lie in [0, 2^key_bits), key_bits <= 23
// for the port's tables, so a least-significant-digit radix sort over those
// bits alone takes 2-3 passes where a general 64-bit sort takes 8.
//
// Design ("onesweep": one launch a pass, the offsets by decoupled look-back).
// The passes and their digit widths (at most 8 bits: 23 bits take 8, 8 and
// 7) are the caller's.  In stream order:
//   0. one memset clears the scratch: the digit histograms, one tile counter
//      and one status array per pass;
//   1. digit_histograms reads the keys once and counts the digits of every
//      pass (shared-memory counts per block, added into the global ones:
//      integer atomics, so the counts do not depend on their order);
//   2. per pass, one launch of onesweep_pass over tiles of 4096 entries
//      (F <= 2), 512 threads a block.  A block takes its tile's index from
//      the pass's atomic counter, so a tile waits only on tiles that have
//      already started and the scheme cannot deadlock.  It loads its keys
//      into registers and starts its value rows into shared memory
//      (cp.async, waited for only before the write out).  A warp owns
//      32 * 8 consecutive entries, 32 a step, lanes in stream order: one
//      ballot per digit bit gives the lanes that share a lane's digit (all
//      steps' ballots first, independent of each other), then a short chain
//      through the warp's per-digit counters gives each entry its rank among
//      the warp's entries of its digit.  Thread d publishes the tile's count
//      of digit d in its status word at once (flag "aggregate"; tile 0 flags
//      it "inclusive"), scans the tile's counts and the digit totals over
//      the block, stages the tile in digit order in shared memory, and only
//      then walks back over the earlier tiles' words of digit d, kWindow at
//      a time, adding aggregates until it meets an inclusive prefix, and
//      publishes its own.  Each digit's entries leave as one contiguous range
//      (16 on average at 8 bits): an entry goes to (entries of smaller
//      digits) + (entries of its digit in earlier tiles) + its rank in the
//      tile, its key and its F values together.
// The passes are launched with programmatic dependent launch: a pass's
// blocks are scheduled while the one before drains and wait for its end in
// griddepcontrol.wait.  A sort is n_passes + 2 operations where the
// three-launch passes took 3 * n_passes.  Measured once on the training
// streams (PERF.md): `__match_any_sync` for the ballots, 12-bit digits in
// two passes, 3 blocks an SM, 2048-entry tiles and look-back windows of 1,
// 16, 32 and 64 words were each slower, a window of 4 no faster.  The
// offsets are exact integer sums
// whatever the order in which blocks run, and there are no float
// operations: the output is exactly addr[o], vals[o] for the stable order o.
// Between passes the keys travel as 32 bits (key_bits <= 32); the first
// pass reads the int64 stream and the last writes int64.
//
// Wide rows (any F outside {1, 2, 4, 8}: the LM's vocab-embedding stream,
// one row of F = d_model floats a token, 4 KiB at F = 1024).  Carrying such
// a row through every pass would move it 2 * n_passes times and leave a
// tile no room in shared memory.  Instead each entry's int32 position in
// the stream is the carried value: the F = 1 instance above sorts (key,
// position), moving the position as 4 bytes of bits and never doing
// arithmetic on it, and one gather then reads each value row once through
// the sorted positions and writes it once, 16 bytes a copy where the rows
// are aligned.  A stable sort's permutation is unique, so the output is the
// same (addr[o], vals[o]).
#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBits = 8;
constexpr int kMaxDigits = 1 << kMaxBits;
constexpr int kMaxPasses = 4;                     // 32 key bits at most
constexpr uint32_t kNoDigit = 0xffffffffu;        // lanes past the stream's end

// A status word: the flag in the top two bits, a count in the low 30.
constexpr uint32_t kAggregate = 1u << 30;         // this tile's count of the digit
constexpr uint32_t kInclusive = 2u << 30;         // ... and of every earlier tile
constexpr uint32_t kCountMask = kAggregate - 1u;
constexpr int kWindow = 8;                        // status words a look-back step reads

// The scratch the memset clears: histograms, tile counters, then the status
// words, all 32-bit.
constexpr int kHistWords = kMaxPasses * kMaxDigits;
constexpr int kHeaderWords = kHistWords + kMaxPasses;

struct Passes {
    int shift[kMaxPasses];
    int width[kMaxPasses];
    int n;
};

__device__ __forceinline__ uint32_t digit_of(int64_t key, int shift, uint32_t mask) {
    return static_cast<uint32_t>(static_cast<uint64_t>(key) >> shift) & mask;
}
__device__ __forceinline__ uint32_t digit_of(uint32_t key, int shift, uint32_t mask) {
    return (key >> shift) & mask;
}

// Status words are read and written by other blocks while this one runs:
// relaxed loads and stores at device scope, never from a stale L1 line.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
    asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// Programmatic dependent launch: a pass's blocks are scheduled while the
// launch before it drains, and wait here until it has completed and its
// writes are visible; each block lets the next launch start once all of
// its own grid's blocks are running.
__device__ __forceinline__ void wait_for_previous_launch() {
    asm volatile("griddepcontrol.wait;" : : : "memory");
}
__device__ __forceinline__ void allow_next_launch() {
    asm volatile("griddepcontrol.launch_dependents;" : : : "memory");
}

// One value row of F floats, moved as whole vectors where F allows.
template <int F>
struct Row {
    float v[F];
};

template <int F>
__device__ __forceinline__ Row<F> load_vals(const float* __restrict__ p) {
    Row<F> r;
    if constexpr (F == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        r.v[0] = x.x;
        r.v[1] = x.y;
    } else if constexpr (F % 4 == 0) {
#pragma unroll
        for (int q = 0; q < F; q += 4) {
            const float4 x = *reinterpret_cast<const float4*>(p + q);
            r.v[q] = x.x;
            r.v[q + 1] = x.y;
            r.v[q + 2] = x.z;
            r.v[q + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int f = 0; f < F; ++f) r.v[f] = p[f];
    }
    return r;
}

template <int F>
__device__ __forceinline__ void store_vals(float* __restrict__ p, const Row<F>& r) {
    if constexpr (F == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
    } else if constexpr (F % 4 == 0) {
#pragma unroll
        for (int q = 0; q < F; q += 4)
            *reinterpret_cast<float4*>(p + q) =
                make_float4(r.v[q], r.v[q + 1], r.v[q + 2], r.v[q + 3]);
    } else {
#pragma unroll
        for (int f = 0; f < F; ++f) p[f] = r.v[f];
    }
}

constexpr int kHistItems = 8;                     // keys a histogram thread reads at once
constexpr int kItems = 8;                         // entries per thread (F <= 2)

// Entries per thread: a tile's values stay within 32 KB of shared memory.
template <int F>
__host__ __device__ constexpr int items_per_thread() {
    return kItems < 16 / F ? kItems : 16 / F;
}

// 1. hist[p * kMaxDigits + d] += the number of keys whose pass-p digit is d.
__global__ void __launch_bounds__(kThreads)
digit_histograms(const int64_t* __restrict__ keys, int m, Passes passes,
                 int* __restrict__ hist) {
    __shared__ int counts[kHistWords];
    allow_next_launch();
    for (int i = threadIdx.x; i < kHistWords; i += kThreads) counts[i] = 0;
    __syncthreads();
    const int stride = gridDim.x * kThreads;
    for (int i0 = blockIdx.x * kThreads + threadIdx.x; i0 < m; i0 += kHistItems * stride) {
        int64_t key[kHistItems];
#pragma unroll
        for (int u = 0; u < kHistItems; ++u) {
            const int i = i0 + u * stride;
            key[u] = i < m ? keys[i] : 0;
        }
#pragma unroll
        for (int u = 0; u < kHistItems; ++u) {
            if (i0 + u * stride >= m) continue;
#pragma unroll
            for (int p = 0; p < kMaxPasses; ++p) {
                if (p < passes.n) {
                    const uint32_t mask = (1u << passes.width[p]) - 1u;
                    atomicAdd(&counts[p * kMaxDigits + digit_of(key[u], passes.shift[p], mask)], 1);
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < passes.n * kMaxDigits; i += kThreads)
        if (counts[i] != 0) atomicAdd(&hist[i], counts[i]);
}

// The sums of a and b over the threads before this one, in thread order, by
// the whole block; ends with a barrier.
__device__ int2 block_prefix(int a, int b, int2* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = a, y = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int xo = __shfl_up_sync(0xffffffffu, x, o);
        const int yo = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) {
            x += xo;
            y += yo;
        }
    }
    if (lane == 31) warp_sums[warp] = make_int2(x, y);
    __syncthreads();
    int2 before = make_int2(x - a, y - b);
    for (int w = 0; w < warp; ++w) {
        before.x += warp_sums[w].x;
        before.y += warp_sums[w].y;
    }
    __syncthreads();
    return before;
}

// The lanes of this warp whose digit equals this lane's (digits of at most
// `width` bits; kNoDigit lanes match only each other): one ballot a bit.
__device__ __forceinline__ unsigned digit_peers(uint32_t d, int width) {
    unsigned peers = __ballot_sync(0xffffffffu, d != kNoDigit);
    if (d == kNoDigit) peers = ~peers;
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) {
        if (b < width) {
            const bool bit = (d >> b) & 1u;
            const unsigned ones = __ballot_sync(0xffffffffu, bit);
            peers &= bit ? ones : ~ones;
        }
    }
    return peers;
}

// The entries of digit d in the tiles before `tile`: walk back over their
// status words, adding aggregates, until an inclusive prefix.  Each step
// reads the words of the kWindow nearest tiles not yet counted at once and
// counts them up to the first inclusive one or the first not yet published
// (that tile has started, so it will publish; the next step reads it again).
__device__ __forceinline__ uint32_t look_back(const uint32_t* __restrict__ status, int tile,
                                              int d) {
    uint32_t before = 0;
    int t = tile - 1;
    while (true) {
        uint32_t s[kWindow];
#pragma unroll
        for (int q = 0; q < kWindow; ++q)
            s[q] = t - q >= 0 ? load_status(status + static_cast<size_t>(t - q) * kMaxDigits + d)
                              : kInclusive;
        bool stop = false;
        int used = 0;
#pragma unroll
        for (int q = 0; q < kWindow; ++q) {
            if (!stop && s[q] >= kAggregate) {
                before += s[q] & kCountMask;
                ++used;
                if (s[q] >= kInclusive) return before;
            } else {
                stop = true;
            }
        }
        t -= used;
    }
}

// 2. One pass: the stable scatter of one tile.  Dynamic shared memory: the
// tile's value rows as they arrive (cp.async, 16 bytes a copy where `vec`
// says the rows are 16-byte aligned), then the tile in digit order -- its keys
// (32 bits) and each key's row in the arrival order (uint16) -- then kWarps
// rows of n_digits counters (warp w's count, then its first position in the
// tile, per digit) and base[n_digits] (the digit's output position less its
// first position in the tile).
template <typename KIn, typename KOut, int F>
__global__ void __launch_bounds__(kThreads)
onesweep_pass(const KIn* __restrict__ keys_in, const float* __restrict__ vals_in,
              KOut* __restrict__ keys_out, float* __restrict__ vals_out,
              const int* __restrict__ totals, int* __restrict__ tile_counter,
              uint32_t* __restrict__ status, int m, int shift, int width, bool vec) {
    constexpr int kN = items_per_thread<F>();
    constexpr int kTile = kThreads * kN;
    static_assert(kMaxDigits <= kThreads, "at most one digit a thread");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int2 warp_sums[kWarps];
    __shared__ int tile_index;
    const int n_digits = 1 << width;
    const uint32_t mask = static_cast<uint32_t>(n_digits - 1);
    float* tile_vals = reinterpret_cast<float*>(smem_raw);                 // (kTile, F)
    uint32_t* tile_keys = reinterpret_cast<uint32_t*>(tile_vals + kTile * F);  // (kTile,)
    uint16_t* tile_src = reinterpret_cast<uint16_t*>(tile_keys + kTile);   // (kTile,)
    int* counters = reinterpret_cast<int*>(tile_src + kTile);              // (kWarps, n_digits)
    int* base = counters + kWarps * n_digits;                              // (n_digits,)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* mine = counters + warp * n_digits;
    const unsigned below = (1u << lane) - 1u;
    const int d = threadIdx.x;                      // the digit this thread places

    allow_next_launch();
    wait_for_previous_launch();
    if (threadIdx.x == 0) tile_index = atomicAdd(tile_counter, 1);
    __syncthreads();
    const int tile = tile_index;
    const int tile0 = tile * kTile;
    const int count = min(m - tile0, kTile);

    // every load first: this digit's total, this warp's 32 * kN consecutive
    // keys, then the tile's value rows
    const int digit_total = d < n_digits ? totals[d] : 0;
    const int warp0 = warp * 32 * kN;
    uint32_t key[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        const int i = tile0 + warp0 + j * 32 + lane;
        key[j] = i < m ? static_cast<uint32_t>(keys_in[i]) : 0u;
    }
    // the tile's value rows, in flight until the write out
    {
        const float* src = vals_in + static_cast<size_t>(tile0) * F;
        const int n_floats = count * F, n_vec = vec ? n_floats / 4 : 0;
        for (int e = threadIdx.x; e < n_vec; e += kThreads)
            mlp_tile::cp_async<16>(tile_vals + 4 * e, src + 4 * e, true);
        for (int e = 4 * n_vec + threadIdx.x; e < n_floats; e += kThreads)
            mlp_tile::cp_async<4>(tile_vals + e, src + e, true);
        mlp_tile::commit();
    }
    // entry j of this lane: its digit, kNoDigit past the stream's end
    auto digit = [&](int j) {
        return warp0 + j * 32 + lane < count ? digit_of(key[j], shift, mask) : kNoDigit;
    };
    if (d < n_digits)
        for (int w = 0; w < kWarps; ++w) counters[w * n_digits + d] = 0;
    __syncthreads();                                // counters zeroed

    // counts per digit, warp by warp, and each entry's rank in its warp:
    // the warp's entries of its digit before it.  The ballots of all kN
    // steps first (independent), then the steps' chain through the counters
    unsigned peers[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) peers[j] = digit_peers(digit(j), width);
    int rank[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        const uint32_t dj = digit(j);
        const int seen = dj != kNoDigit ? mine[dj] : 0;
        __syncwarp();
        if (dj != kNoDigit && (peers[j] & below) == 0) mine[dj] = seen + __popc(peers[j]);
        rank[j] = seen + __popc(peers[j] & below);
        __syncwarp();
    }
    __syncthreads();

    // publish the tile's count of digit d at once, so later tiles can go on
    int tile_count = 0;
    if (d < n_digits) {
        for (int w = 0; w < kWarps; ++w) tile_count += counters[w * n_digits + d];
        uint32_t* word = status + static_cast<size_t>(tile) * kMaxDigits + d;
        store_status(word, (tile == 0 ? kInclusive : kAggregate) | static_cast<uint32_t>(tile_count));
    }

    // digit d's entries of this tile start at in_tile (digits in order, then
    // warps in order) and go to (all entries of smaller digits) + earlier on
    const int2 before = block_prefix(tile_count, digit_total, warp_sums);
    if (d < n_digits) {
        base[d] = before.y - before.x;
        int run = before.x;
        for (int w = 0; w < kWarps; ++w) {
            const int c = counters[w * n_digits + d];
            counters[w * n_digits + d] = run;
            run += c;
        }
    }
    __syncthreads();

    // the tile in digit order: keys and where their rows are
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        const uint32_t dj = digit(j);
        if (dj != kNoDigit) {
            const int pos = mine[dj] + rank[j];
            tile_keys[pos] = key[j];
            tile_src[pos] = static_cast<uint16_t>(warp0 + j * 32 + lane);
        }
    }

    // the entries of digit d in earlier tiles; then this tile's inclusive
    // prefix, for the tiles after it
    if (d < n_digits && tile > 0) {
        const uint32_t earlier = look_back(status, tile, d);
        store_status(status + static_cast<size_t>(tile) * kMaxDigits + d,
                     kInclusive | (earlier + static_cast<uint32_t>(tile_count)));
        base[d] += static_cast<int>(earlier);
    }
    mlp_tile::wait<0>();
    __syncthreads();

    // write the tile out: a digit's entries are one contiguous range
#pragma unroll 4
    for (int e = threadIdx.x; e < count; e += kThreads) {
        const uint32_t k = tile_keys[e];
        const int g = base[digit_of(k, shift, mask)] + e;
        keys_out[g] = static_cast<KOut>(k);
        store_vals<F>(vals_out + static_cast<size_t>(g) * F,
                      load_vals<F>(tile_vals + static_cast<int>(tile_src[e]) * F));
    }
}

template <int F>
size_t pass_smem(int width) {
    constexpr int kTile = kThreads * items_per_thread<F>();
    return (sizeof(float) * F + sizeof(uint32_t) + sizeof(uint16_t)) * kTile +
           sizeof(int) * static_cast<size_t>(kWarps + 1) * (1u << width);
}

template <typename KIn, typename KOut, int F>
int run_pass(const KIn* keys_in, const float* vals_in, KOut* keys_out, float* vals_out,
             const int* totals, int* tile_counter, uint32_t* status, int m, int n_tiles,
             int shift, int width, cudaStream_t stream) {
    auto kernel = onesweep_pass<KIn, KOut, F>;
    const bool vec = reinterpret_cast<uintptr_t>(vals_in) % 16 == 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(pass_smem<F>(kMaxBits)));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(n_tiles);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = pass_smem<F>(width);
    config.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, keys_in, vals_in, keys_out, vals_out, totals,
                             tile_counter, status, m, shift, width, vec);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <int F>
int sort_stream(const int64_t* keys, const float* vals, int64_t* keys_out, float* vals_out,
                uint32_t* key_tmp0, uint32_t* key_tmp1, float* vals_tmp, int* scratch, int m,
                const Passes& passes, cudaStream_t s) {
    constexpr int kTile = kThreads * items_per_thread<F>();
    const int n_tiles = (m + kTile - 1) / kTile;
    const size_t status_words = static_cast<size_t>(passes.n) * n_tiles * kMaxDigits;
    cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * (kHeaderWords + status_words), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int* hist = scratch;
    int* tile_counters = scratch + kHistWords;
    uint32_t* status = reinterpret_cast<uint32_t*>(scratch + kHeaderWords);
    const int hist_blocks = min((m + kThreads * kHistItems - 1) / (kThreads * kHistItems), 1024);
    digit_histograms<<<hist_blocks, kThreads, 0, s>>>(keys, m, passes, hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // pass p reads what pass p-1 wrote; the last pass writes the outputs, so
    // the values of pass p go to vals_out when n_passes - 1 - p is even
    const uint32_t* k_src = nullptr;
    const float* v_src = vals;
    for (int p = 0; p < passes.n; ++p) {
        const int shift = passes.shift[p], width = passes.width[p];
        float* v_dst = (passes.n - 1 - p) % 2 == 0 ? vals_out : vals_tmp;
        uint32_t* k_dst = p % 2 == 0 ? key_tmp0 : key_tmp1;
        const bool last = p == passes.n - 1;
        const int* totals = hist + p * kMaxDigits;
        uint32_t* st = status + static_cast<size_t>(p) * n_tiles * kMaxDigits;
        int* counter = tile_counters + p;
        int status_code;
        if (p == 0 && last) {
            status_code = run_pass<int64_t, int64_t, F>(keys, v_src, keys_out, v_dst, totals,
                                                        counter, st, m, n_tiles, shift, width, s);
        } else if (p == 0) {
            status_code = run_pass<int64_t, uint32_t, F>(keys, v_src, k_dst, v_dst, totals,
                                                         counter, st, m, n_tiles, shift, width, s);
        } else if (last) {
            status_code = run_pass<uint32_t, int64_t, F>(k_src, v_src, keys_out, v_dst, totals,
                                                         counter, st, m, n_tiles, shift, width, s);
        } else {
            status_code = run_pass<uint32_t, uint32_t, F>(k_src, v_src, k_dst, v_dst, totals,
                                                          counter, st, m, n_tiles, shift, width, s);
        }
        if (status_code != 0) return status_code;
        k_src = k_dst;
        v_src = v_dst;
    }
    return 0;
}

// Each entry's position in the stream, the value the wide sort carries.
__global__ void stream_positions(uint32_t* __restrict__ pos, int m) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) pos[i] = static_cast<uint32_t>(i);
}

// out[i] = vals[perm[i]], one block a row, V floats a thread and copy.
template <int V>
__global__ void gather_rows(const uint32_t* __restrict__ perm, const float* __restrict__ vals,
                            float* __restrict__ out, int f) {
    const int64_t i = blockIdx.x;
    const float* src = vals + static_cast<int64_t>(__ldg(perm + i)) * f;
    float* dst = out + i * f;
    for (int c = threadIdx.x * V; c < f; c += blockDim.x * V) {
        if constexpr (V == 4)
            *reinterpret_cast<float4*>(dst + c) = __ldg(reinterpret_cast<const float4*>(src + c));
        else
            dst[c] = __ldg(src + c);
    }
}

// The passes of `widths`, validated: false if any width or their sum is out
// of range.
bool make_passes(const int* widths, int n_passes, Passes* passes) {
    if (n_passes < 1 || n_passes > kMaxPasses) return false;
    passes->n = n_passes;
    int bits = 0;
    for (int p = 0; p < n_passes; ++p) {
        if (widths[p] < 1 || widths[p] > kMaxBits) return false;
        passes->shift[p] = bits;
        passes->width[p] = widths[p];
        bits += widths[p];
    }
    return bits <= 32;
}

}  // namespace

// keys (m,) int64 in [0, 2^(sum of widths)), vals (m, n_features) f32 ->
// keys_out (m,) int64, vals_out (m, n_features) f32, stably sorted by key.
// Scratch: key_tmp0 and key_tmp1 (m,) uint32 (key_tmp1 unused below three
// passes), vals_tmp (m, n_features) f32 (unused for one pass), scratch
// (4 * 256 + 4 + n_passes * ceil(m / tile) * 256,) int32, cleared here,
// tile = 256 * min(16, 32 / n_features) entries.
// widths: host array of n_passes digit widths in [1, 8], least significant
// first, summing to at most 32.  All device arrays contiguous and distinct,
// on the current device, rows of vals aligned to their vector width;
// m < 2^30.  Returns the CUDA status of the first operation that failed (0
// on success).
extern "C" int bum_sort_stream(const int64_t* keys, const float* vals, int64_t* keys_out,
                               float* vals_out, uint32_t* key_tmp0, uint32_t* key_tmp1,
                               float* vals_tmp, int* scratch, int m, int n_features,
                               const int* widths, int n_passes, void* stream) {
    Passes passes{};
    if (m < 0 || static_cast<uint32_t>(m) > kCountMask || !make_passes(widths, n_passes, &passes))
        return static_cast<int>(cudaErrorInvalidValue);
    if (m == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_features) {
        case 1: return sort_stream<1>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, scratch, m, passes, s);
        case 2: return sort_stream<2>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, scratch, m, passes, s);
        case 4: return sort_stream<4>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, scratch, m, passes, s);
        case 8: return sort_stream<8>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, scratch, m, passes, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}


// The wide route: keys (m,) int64 as above, vals (m, n_features) f32 with
// any n_features >= 1 -> keys_out, vals_out sorted as above.  Scratch as
// above for one value column: key_tmp0, key_tmp1 (m,) uint32, pos and
// pos_out (m,) uint32, pos_tmp (m,) uint32 (unused for one pass), scratch
// sized for n_features = 1.  Rows of vals and vals_out 16-byte aligned when
// n_features % 4 == 0 to be copied 16 bytes at a time.  Returns the CUDA
// status of the first operation that failed (0 on success).
extern "C" int bum_sort_rows(const int64_t* keys, const float* vals, int64_t* keys_out,
                             float* vals_out, uint32_t* key_tmp0, uint32_t* key_tmp1,
                             uint32_t* pos, uint32_t* pos_tmp, uint32_t* pos_out, int* scratch,
                             int m, int n_features, const int* widths, int n_passes,
                             void* stream) {
    Passes passes{};
    if (m < 0 || static_cast<uint32_t>(m) > kCountMask || n_features < 1 ||
        !make_passes(widths, n_passes, &passes))
        return static_cast<int>(cudaErrorInvalidValue);
    if (m == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    stream_positions<<<(m + 255) / 256, 256, 0, s>>>(pos, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int status = sort_stream<1>(keys, reinterpret_cast<const float*>(pos), keys_out,
                                      reinterpret_cast<float*>(pos_out), key_tmp0, key_tmp1,
                                      reinterpret_cast<float*>(pos_tmp), scratch, m, passes, s);
    if (status != 0) return status;
    const bool vec = n_features % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(vals_out)) % 16 == 0;
    const int per_thread = vec ? 4 : 1;
    const int nv = (n_features + per_thread - 1) / per_thread;
    const int threads = nv >= 256 ? 256 : (nv + 31) / 32 * 32;
    if (vec)
        gather_rows<4><<<m, threads, 0, s>>>(pos_out, vals, vals_out, n_features);
    else
        gather_rows<1><<<m, threads, 0, s>>>(pos_out, vals, vals_out, n_features);
    return static_cast<int>(cudaGetLastError());
}
