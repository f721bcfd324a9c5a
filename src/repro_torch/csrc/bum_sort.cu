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
// Design: per pass (a digit of at most 8 bits, the passes and widths chosen
// by the caller: 23 bits take three passes of 8, 8 and 7) three launches,
// in stream order:
//   1. tile_histogram: each tile of 4096 consecutive entries (F <= 2)
//      counts its digits in shared memory (integer atomics: a count does not
//      depend on their order) into spine[digit][tile];
//   2. spine_scan: one warp per digit turns its row into exclusive prefix
//      sums over the tiles, in tile order, and writes the digit's total;
//   3. tile_scatter: a block loads its tile (keys in registers, value rows
//      into shared memory) and ranks the entries stably: a warp owns 32 * 16
//      consecutive entries and walks them 32 at a time, lanes in stream
//      order; one ballot per digit bit groups the lanes of one digit, and a
//      lane's rank is the number of its group's lanes below it plus the
//      entries of that digit the warp has already placed, the warps' counts
//      chained in warp order.  The tile is staged in shared memory in digit
//      order and written out from there, so that each digit's entries leave
//      as one contiguous range (16 on average at 8 bits): an entry goes to
//      (entries of smaller digits) + (entries of its digit in earlier
//      tiles) + its rank, its key and its F values together.
// Digits of 11 bits (two passes where 21-22 bits take three of 8) and tiles
// of 2048 entries were measured slower on the main paths' streams.
// Nothing depends on the order in which threads or blocks run, and there are
// no float operations: the output is exactly addr[o], vals[o] for the stable
// order o.  Between passes the keys travel as 32 bits (key_bits <= 32); the
// first pass reads the int64 stream and the last writes int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBits = 8;
constexpr int kMaxDigits = 1 << kMaxBits;
constexpr uint32_t kNoDigit = 0xffffffffu;        // lanes past the stream's end

__device__ __forceinline__ uint32_t digit_of(int64_t key, int shift, uint32_t mask) {
    return static_cast<uint32_t>(static_cast<uint64_t>(key) >> shift) & mask;
}
__device__ __forceinline__ uint32_t digit_of(uint32_t key, int shift, uint32_t mask) {
    return (key >> shift) & mask;
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

constexpr int kItems = 16;                        // entries per thread (F <= 2)

// Entries per thread: a tile's values stay within 32 KB of shared memory.
template <int F>
__host__ __device__ constexpr int items_per_thread() {
    return kItems < 32 / F ? kItems : 32 / F;
}

// 1. spine[d * n_tiles + tile] = the number of entries of digit d in the tile.
template <typename K, int F>
__global__ void __launch_bounds__(kThreads)
tile_histogram(const K* __restrict__ keys, int m, int shift, int width, int n_tiles,
               int* __restrict__ spine) {
    constexpr int kTile = kThreads * items_per_thread<F>();
    __shared__ int hist[kMaxDigits];
    const int n_digits = 1 << width;
    const uint32_t mask = static_cast<uint32_t>(n_digits - 1);
    for (int d = threadIdx.x; d < n_digits; d += kThreads) hist[d] = 0;
    __syncthreads();
    constexpr int kN = items_per_thread<F>();
    const int base = blockIdx.x * kTile;
    uint32_t dig[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        const int i = base + j * kThreads + static_cast<int>(threadIdx.x);
        dig[j] = i < m ? digit_of(keys[i], shift, mask) : kNoDigit;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
        if (dig[j] != kNoDigit) atomicAdd(&hist[dig[j]], 1);
    __syncthreads();
    for (int d = threadIdx.x; d < n_digits; d += kThreads)
        spine[static_cast<size_t>(d) * n_tiles + blockIdx.x] = hist[d];
}

// 2. Row d of the spine -> its exclusive prefix sums over the tiles;
// totals[d] = the row's sum.  One warp per digit.
__global__ void __launch_bounds__(kThreads)
spine_scan(int* __restrict__ spine, int* __restrict__ totals, int n_tiles, int n_digits) {
    const int d = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (d >= n_digits) return;                      // whole warps
    int* row = spine + static_cast<size_t>(d) * n_tiles;
    int carry = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
        const int t = t0 + lane;
        const int c = t < n_tiles ? row[t] : 0;
        int x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (t < n_tiles) row[t] = carry + x - c;
        carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) totals[d] = carry;
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

// 3. The stable scatter of one tile.  Dynamic shared memory: the tile's
// value rows as they arrive, then the tile in digit order -- its keys (KOut)
// and each key's row in the arrival order (uint16) -- then kWarps rows of
// n_digits counters (warp w's count, then its first position in the tile, per
// digit) and base[n_digits] (the digit's output position less its first
// position in the tile).
template <typename KIn, typename KOut, int F>
__global__ void __launch_bounds__(kThreads)
tile_scatter(const KIn* __restrict__ keys_in, const float* __restrict__ vals_in,
             KOut* __restrict__ keys_out, float* __restrict__ vals_out,
             const int* __restrict__ spine, const int* __restrict__ totals,
             int m, int shift, int width, int n_tiles) {
    constexpr int kN = items_per_thread<F>();
    constexpr int kTile = kThreads * kN;
    constexpr int kVec = kTile * F / 4 / kThreads;  // 16-byte value vectors a thread
    static_assert(kMaxDigits == kThreads, "one digit a thread");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int2 warp_sums[kWarps];
    const int n_digits = 1 << width;
    const uint32_t mask = static_cast<uint32_t>(n_digits - 1);
    float* tile_vals = reinterpret_cast<float*>(smem_raw);                 // (kTile, F)
    KOut* tile_keys = reinterpret_cast<KOut*>(tile_vals + kTile * F);      // (kTile,)
    uint16_t* tile_src = reinterpret_cast<uint16_t*>(tile_keys + kTile);   // (kTile,)
    int* counters = reinterpret_cast<int*>(tile_src + kTile);              // (kWarps, n_digits)
    int* base = counters + kWarps * n_digits;                              // (n_digits,)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* mine = counters + warp * n_digits;
    const unsigned below = (1u << lane) - 1u;
    const int tile0 = blockIdx.x * kTile;
    const int count = min(m - tile0, kTile);
    const int d = threadIdx.x;                      // the digit this thread places

    // every load first: this digit's total and its count in earlier tiles,
    // the tile's value rows (whole 16-byte vectors where the tile's floats
    // allow) and this warp's 32 * kN consecutive keys
    const int digit_total = d < n_digits ? totals[d] : 0;
    const int earlier = d < n_digits ? spine[static_cast<size_t>(d) * n_tiles + blockIdx.x] : 0;
    const float* src = vals_in + static_cast<size_t>(tile0) * F;
    const bool whole = (count * F) % 4 == 0;
    float4 vec[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
        const int e = q * kThreads + threadIdx.x;
        if (whole && e < count * F / 4) vec[q] = reinterpret_cast<const float4*>(src)[e];
    }
    const int warp0 = warp * 32 * kN;
    KIn key[kN];
    uint32_t dig[kN];
    unsigned peers[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        const int i = tile0 + warp0 + j * 32 + lane;
        key[j] = i < m ? keys_in[i] : KIn(0);
        dig[j] = i < m ? digit_of(key[j], shift, mask) : kNoDigit;
    }
    if (d < n_digits)
        for (int w = 0; w < kWarps; ++w) counters[w * n_digits + d] = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
        const int e = q * kThreads + threadIdx.x;
        if (whole && e < count * F / 4) reinterpret_cast<float4*>(tile_vals)[e] = vec[q];
    }
    if (!whole)
        for (int e = threadIdx.x; e < count * F; e += kThreads) tile_vals[e] = src[e];
    __syncthreads();                                // counters zeroed

    // counts per digit, warp by warp
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        peers[j] = digit_peers(dig[j], width);
        if (dig[j] != kNoDigit && (peers[j] & below) == 0) mine[dig[j]] += __popc(peers[j]);
        __syncwarp();
    }
    __syncthreads();

    // digit d's entries of this tile start at in_tile (digits in order, then
    // warps in order) and go to (all entries of smaller digits) + earlier on
    int tile_count = 0;
    if (d < n_digits)
        for (int w = 0; w < kWarps; ++w) tile_count += counters[w * n_digits + d];
    const int2 before = block_prefix(tile_count, digit_total, warp_sums);
    if (d < n_digits) {
        base[d] = before.y + earlier - before.x;
        int run = before.x;
        for (int w = 0; w < kWarps; ++w) {
            const int c = counters[w * n_digits + d];
            counters[w * n_digits + d] = run;
            run += c;
        }
    }
    __syncthreads();

    // rank stably; the tile in digit order: keys and where their rows are
#pragma unroll
    for (int j = 0; j < kN; ++j) {
        int pos = 0;
        if (dig[j] != kNoDigit) pos = mine[dig[j]] + __popc(peers[j] & below);
        __syncwarp();
        if (dig[j] != kNoDigit) {
            if ((peers[j] & below) == 0) mine[dig[j]] += __popc(peers[j]);
            tile_keys[pos] = static_cast<KOut>(key[j]);
            tile_src[pos] = static_cast<uint16_t>(warp0 + j * 32 + lane);
        }
        __syncwarp();
    }
    __syncthreads();

    // write the tile out: a digit's entries are one contiguous range
    for (int e = threadIdx.x; e < count; e += kThreads) {
        const KOut k = tile_keys[e];
        const int g = base[digit_of(k, shift, mask)] + e;
        keys_out[g] = k;
        store_vals<F>(vals_out + static_cast<size_t>(g) * F,
                      load_vals<F>(tile_vals + static_cast<int>(tile_src[e]) * F));
    }
}

template <typename KOut, int F>
size_t scatter_smem(int width) {
    constexpr int kTile = kThreads * items_per_thread<F>();
    return (sizeof(float) * F + sizeof(KOut) + sizeof(uint16_t)) * kTile +
           sizeof(int) * static_cast<size_t>(kWarps + 1) * (1u << width);
}

template <typename KIn, typename KOut, int F>
int run_pass(const KIn* keys_in, const float* vals_in, KOut* keys_out, float* vals_out,
             int* spine, int* totals, int m, int shift, int width, cudaStream_t stream) {
    constexpr int kTile = kThreads * items_per_thread<F>();
    const int n_tiles = (m + kTile - 1) / kTile;
    const int n_digits = 1 << width;
    tile_histogram<KIn, F><<<n_tiles, kThreads, 0, stream>>>(keys_in, m, shift, width,
                                                             n_tiles, spine);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    spine_scan<<<(n_digits * 32 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        spine, totals, n_tiles, n_digits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = tile_scatter<KIn, KOut, F>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scatter_smem<KOut, F>(kMaxBits)));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_tiles, kThreads, scatter_smem<KOut, F>(width), stream>>>(
        keys_in, vals_in, keys_out, vals_out, spine, totals, m, shift, width, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <int F>
int sort_stream(const int64_t* keys, const float* vals, int64_t* keys_out, float* vals_out,
                uint32_t* key_tmp0, uint32_t* key_tmp1, float* vals_tmp, int* spine,
                int* totals, int m, const int* widths, int n_passes, cudaStream_t s) {
    // pass p reads what pass p-1 wrote; the last pass writes the outputs, so
    // the values of pass p go to vals_out when n_passes - 1 - p is even
    const uint32_t* k_src = nullptr;
    const float* v_src = vals;
    int shift = 0;
    for (int p = 0; p < n_passes; ++p) {
        const int width = widths[p];
        float* v_dst = (n_passes - 1 - p) % 2 == 0 ? vals_out : vals_tmp;
        uint32_t* k_dst = p % 2 == 0 ? key_tmp0 : key_tmp1;
        const bool last = p == n_passes - 1;
        int status;
        if (p == 0 && last) {
            status = run_pass<int64_t, int64_t, F>(keys, v_src, keys_out, v_dst, spine, totals,
                                                   m, shift, width, s);
        } else if (p == 0) {
            status = run_pass<int64_t, uint32_t, F>(keys, v_src, k_dst, v_dst, spine, totals,
                                                    m, shift, width, s);
        } else if (last) {
            status = run_pass<uint32_t, int64_t, F>(k_src, v_src, keys_out, v_dst, spine,
                                                    totals, m, shift, width, s);
        } else {
            status = run_pass<uint32_t, uint32_t, F>(k_src, v_src, k_dst, v_dst, spine,
                                                     totals, m, shift, width, s);
        }
        if (status != 0) return status;
        k_src = k_dst;
        v_src = v_dst;
        shift += width;
    }
    return 0;
}

}  // namespace

// keys (m,) int64 in [0, 2^(sum of widths)), vals (m, n_features) f32 ->
// keys_out (m,) int64, vals_out (m, n_features) f32, stably sorted by key.
// Scratch: key_tmp0 and key_tmp1 (m,) uint32 (key_tmp1 unused below three
// passes), vals_tmp (m, n_features) f32 (unused for one pass), spine
// (2^max width * ceil(m / tile),) int32, tile = 256 * min(16, 32 /
// n_features) entries, totals (2^max width,) int32.
// widths: host array of n_passes digit widths in [1, 8], least significant
// first, summing to at most 32.  All device arrays contiguous and distinct,
// on the current device, rows of vals aligned to their vector width.
// Returns the CUDA status of the first launch that failed (0 on success).
extern "C" int bum_sort_stream(const int64_t* keys, const float* vals, int64_t* keys_out,
                               float* vals_out, uint32_t* key_tmp0, uint32_t* key_tmp1,
                               float* vals_tmp, int* spine, int* totals, int m,
                               int n_features, const int* widths, int n_passes,
                               void* stream) {
    int bits = 0;
    for (int p = 0; p < n_passes; ++p) {
        if (widths[p] < 1 || widths[p] > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
        bits += widths[p];
    }
    if (m < 0 || n_passes < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
    if (m == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_features) {
        case 1: return sort_stream<1>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, spine, totals, m, widths, n_passes, s);
        case 2: return sort_stream<2>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, spine, totals, m, widths, n_passes, s);
        case 4: return sort_stream<4>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, spine, totals, m, widths, n_passes, s);
        case 8: return sort_stream<8>(keys, vals, keys_out, vals_out, key_tmp0, key_tmp1,
                                      vals_tmp, spine, totals, m, widths, n_passes, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
