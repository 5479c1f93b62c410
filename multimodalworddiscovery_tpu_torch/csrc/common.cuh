// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface,
// bound from Python with ctypes by ops/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Large finite negative instead of -inf, as in core/logsemiring.py: exp of
// it is 0 in fp32 and sums of two do not overflow to nan.
#define MWD_NEG_INF (-1e30f)

// Largest state count the fused discrete-HMM route takes (its gate in
// models/hmm.py is S <= 64).
#define MWD_MAX_S 64

// Largest state count of the general E-step (K4) and of the Viterbi
// decoder (K3).  Both keep exp(base0) or base, [S, S + 1] floats, in shared
// memory, and K4's backward adds the [S, S] xi table: at S = 160 that is
// 206,848 bytes of the 232,448 a block may opt into on the H100.
#define MWD_MAX_S_GENERAL 160

// Dynamic shared memory a block may use after opting in (H100: 227 KB).
#define MWD_SMEM_OPTIN_MAX 232448

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static int mwd_smem_optin(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

static inline int mwd_state_threads(int s) { return ((s + 31) / 32) * 32; }

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

// Block-wide argmax; every thread gets the winning index.  `red_v` and
// `red_i` are shared scratch of >= 32 entries each.
__device__ __forceinline__ int mwd_block_argmax(float v, int i, float* red_v, int* red_i) {
    i = mwd_warp_argmax(v, i);
    const int nw = blockDim.x >> 5;
    if (nw == 1) return i;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        red_v[threadIdx.x >> 5] = v;
        red_i[threadIdx.x >> 5] = i;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    v = lane < nw ? red_v[lane] : -INFINITY;
    i = lane < nw ? red_i[lane] : 0x7fffffff;
    return mwd_warp_argmax(v, i);
}
