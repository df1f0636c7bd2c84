// Error reporting for the ctypes wrappers.
#include "common.cuh"

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
