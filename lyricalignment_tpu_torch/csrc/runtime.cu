// Error text for the codes the launchers return.
#include "common.cuh"

LA_API const char* la_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
