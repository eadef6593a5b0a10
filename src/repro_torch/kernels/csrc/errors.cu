// Error text for the codes the entry points return.
#include "common.cuh"

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
