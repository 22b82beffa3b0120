// Error reporting for the ctypes wrappers: every entry point returns the
// cudaGetLastError() code of its launch, and this turns it into text.
#include <cuda_runtime.h>

extern "C" const char* bbme_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
