// Shared by every kernel source of repro_torch.  Each source builds into its
// own shared library with a plain C interface (loaded from Python with
// ctypes), so each library exports its own copy of the error-string lookup
// that the Python wrappers use to report a failed launch.  The in-block
// bitonic sort serves the fused encode's dedup of a block's corner addresses
// (fused_encode.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Ascending bitonic sort of N (a power of two) 64-bit keys in shared memory
// by the whole block.  Call it after a __syncthreads() that publishes the
// keys; it ends with one, so the sorted keys are visible to every thread.
template <int N>
__device__ void bitonic_sort(unsigned long long* keys) {
    static_assert((N & (N - 1)) == 0, "bitonic_sort needs a power of two");
    for (int k = 2; k <= N; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < N; t += blockDim.x) {
                const int u = t ^ j;
                if (u > t) {
                    const unsigned long long a = keys[t], b = keys[u];
                    const bool ascending = (t & k) == 0;
                    if ((a > b) == ascending) {
                        keys[t] = b;
                        keys[u] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}
