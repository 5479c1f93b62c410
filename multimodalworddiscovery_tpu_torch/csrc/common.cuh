// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface,
// bound from Python with ctypes by ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// Large finite negative instead of -inf, as in core/logsemiring.py: exp of
// it is 0 in fp32 and sums of two do not overflow to nan.
#define MWD_NEG_INF (-1e30f)

// Dynamic shared memory a block may use after opting in (H100: 227 KB),
// and the shared memory of one SM (228 KB; a block reserves 1 KB of it).
#define MWD_SMEM_OPTIN_MAX 232448
#define MWD_SMEM_SM 233472

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static int mwd_smem_optin(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

__device__ __forceinline__ float mwd_warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float mwd_warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide max for blockDim.x a multiple of 32; every thread gets the
// result.  `red` is a shared scratch of >= 32 floats, reused between
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

// (value, index) pair that wins an argmax: the larger value, and on a tie
// the lower index (torch.argmax's and jnp.argmax's rule).
__device__ __forceinline__ void mwd_argmax_pick(float& v, int& i, float ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

__device__ __forceinline__ int mwd_warp_argmax(float& v, int i) {
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        mwd_argmax_pick(v, i, ov, oi);
    }
    return i;
}

// An operand of a product as the TPU kernel's MXU reads it: unchanged in
// fp32, rounded to bf16 (nearest even) and widened back with BF16.
template <bool BF16>
__device__ __forceinline__ float mwd_dot_in(float x) {
    if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
    return x;
}
