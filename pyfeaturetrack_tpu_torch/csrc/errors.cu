// Error strings for the C entry points' return codes.

#include "common.cuh"

extern "C" const char* pft_error_string(int code)
{
    if (code == PFT_INVALID_ARGUMENT) return "argument the kernel does not take";
    return cudaGetErrorString((cudaError_t)code);
}
