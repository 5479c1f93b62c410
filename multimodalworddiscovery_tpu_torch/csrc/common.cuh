// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface,
// bound from Python with ctypes by ops/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Large finite negative instead of -inf, as in core/logsemiring.py: exp of
// it is 0 in fp32 and sums of two do not overflow to nan.
#define MWD_NEG_INF (-1e30f)

// Largest state count the HMM kernels take: [S, S] tables live in shared
// memory (the fused discrete-HMM route is gated at S <= 64).
#define MWD_MAX_S 64

__device__ __forceinline__ float mwd_warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float mwd_warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide max / sum for blockDim.x a multiple of 32; every thread gets
// the result.  `red` is a shared scratch of >= 32 floats, reused between
// calls (the leading barrier keeps a second call from overwriting it while
// a first is still being read).
__device__ __forceinline__ float mwd_block_max(float v, float* red) {
    v = mwd_warp_max(v);
    const int nw = blockDim.x >> 5;
    if (nw == 1) return v;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = (threadIdx.x & 31) < nw ? red[threadIdx.x & 31] : -INFINITY;
    return mwd_warp_max(v);
}

__device__ __forceinline__ float mwd_block_sum(float v, float* red) {
    v = mwd_warp_sum(v);
    const int nw = blockDim.x >> 5;
    if (nw == 1) return v;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = (threadIdx.x & 31) < nw ? red[threadIdx.x & 31] : 0.f;
    return mwd_warp_sum(v);
}
