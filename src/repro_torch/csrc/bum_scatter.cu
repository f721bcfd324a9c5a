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
// Design: the TPU kernel walked the sorted stream in blocks, one after
// another, summing runs with a one-hot matmul and letting later blocks add
// onto what earlier ones wrote -- sound only because a TPU grid runs in
// order.  Here blocks run in parallel, so no two threads may write one row:
// one thread per stream entry, and only the thread at a run start
// (idx[i] != idx[i-1]) does any work.  It walks its run in stream order,
// sums it from zero, and adds the sum to its row once.  Every address has
// exactly one run start, so there is no race and no float atomic, and the
// result is the same bits on every run: the sum of each run is the
// reference's segment_sum in stream order.  Adds use __fadd_rn so the
// compiler cannot reassociate them.  Entries outside [0, T) -- the spill
// row T that pads a stream -- are dropped.  A long run is summed by one
// thread while its neighbours idle; the stream's runs are short (a few
// dozen entries at the coarsest level), so that is accepted for now.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
bum_scatter_kernel(const int64_t* __restrict__ idx, const float* __restrict__ vals,
                   float* __restrict__ table, int64_t m, int64_t table_rows) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int64_t a = idx[i];
    if (i > 0 && idx[i - 1] == a) return;          // not a run start
    if (a < 0 || a >= table_rows) return;          // spill row: dropped

    float sum[F];
#pragma unroll
    for (int f = 0; f < F; ++f) sum[f] = 0.0f;
    for (int64_t j = i; j < m && idx[j] == a; ++j) {
#pragma unroll
        for (int f = 0; f < F; ++f) sum[f] = __fadd_rn(sum[f], vals[j * F + f]);
    }
    float* row = table + a * F;
#pragma unroll
    for (int f = 0; f < F; ++f) row[f] = __fadd_rn(row[f], sum[f]);
}

template <int F>
void launch(const int64_t* idx, const float* vals, float* table, int64_t m,
            int64_t table_rows, cudaStream_t stream) {
    const int64_t blocks = (m + kThreads - 1) / kThreads;
    bum_scatter_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        idx, vals, table, m, table_rows);
}

}  // namespace

// idx (m,) int64 non-decreasing; vals (m, n_features) f32; table
// (table_rows, n_features) f32, updated in place.  Contiguous, on the current
// device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bum_scatter_commit(const int64_t* idx, const float* vals, float* table,
                                  int64_t m, int64_t table_rows, int n_features,
                                  void* stream) {
    if (m < 0 || table_rows < 0 || m / kThreads >= 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_features) {
        case 1: launch<1>(idx, vals, table, m, table_rows, s); break;
        case 2: launch<2>(idx, vals, table, m, table_rows, s); break;
        case 4: launch<4>(idx, vals, table, m, table_rows, s); break;
        case 8: launch<8>(idx, vals, table, m, table_rows, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
