// What every kernel library of tpufem_torch shares: the CUDA headers and
// the C entry point that turns a returned error code into its message
// (ops/cuda.py, CudaKernel.launch).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
