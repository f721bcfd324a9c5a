// Shared by every kernel source of repro_torch.  Each source builds into its
// own shared library with a plain C interface (loaded from Python with
// ctypes), so each library exports its own copy of the error-string lookup
// that the Python wrappers use to report a failed launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
