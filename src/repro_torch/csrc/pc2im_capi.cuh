// Plain C interface shared by the kernel libraries under csrc/.
//
// Each .cu file is compiled on its own into a shared library and loaded with
// ctypes (kernels/build.py).  Every entry point returns cudaGetLastError()
// right after its launch, so a launch the card refuses (too many threads, too
// much shared memory) raises in the Python wrapper instead of vanishing.
#pragma once

#include <cuda_runtime.h>

#define PC2IM_API extern "C" __attribute__((visibility("default")))

// Text of a status returned by one of this library's entry points.
PC2IM_API const char* pc2im_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Make `device` current for this library's runtime: the library links its
// own copy of the CUDA runtime, whose current device is independent of
// PyTorch's.
static inline int pc2im_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
