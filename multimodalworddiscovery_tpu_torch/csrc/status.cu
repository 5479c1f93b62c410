// Error text for the status codes the C entry points return.

#include <cuda_runtime.h>

extern "C" const char* mwd_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
