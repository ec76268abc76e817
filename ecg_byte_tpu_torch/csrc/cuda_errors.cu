// The message of a CUDA error code, for the Python wrappers: every C entry
// point of this library returns the cudaError_t of its launch, and
// ops/_cuda.check raises with this text when it is not 0.

#include <cuda_runtime.h>

extern "C" const char* ecg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
