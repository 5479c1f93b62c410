// The length order shared by K2, K3 and K4: utterances longest first, ties
// in index order, so that the utterances a warp or a block takes together
// have similar lengths and each sweep stops at its longest.
//
// perm[rank] = n, rank = the number of utterances longer than n, or as long
// and before it: the number of keys len * 2^32 + (2^32 - 1 - index) above
// n's (the keys are distinct; 0 pads a tile and is below every key).  That
// is N^2 comparisons, ranked again on every call although an EM run's
// lengths do not change: mwd_length_rank splits them over a 2-D grid, each
// block comparing MWD_ORDER_NT utterances with one slice of MWD_ORDER_SLICE
// (64 M comparisons at N = 8000 in 512 blocks), and writes one partial
// count per slice; the perm kernel sums an utterance's partials in slice
// order and scatters it.  No atomics and no zeroing: the order is the same
// from run to run, and it is made only here, on the card.
#pragma once

#include "common.cuh"

#define MWD_ORDER_NT 256
#define MWD_ORDER_SLICE 512

__host__ __device__ inline int mwd_order_slices(int n) { return (n + MWD_ORDER_SLICE - 1) / MWD_ORDER_SLICE; }

__device__ __forceinline__ unsigned long long mwd_len_key(int len, int idx) {
    return ((unsigned long long)(unsigned)len << 32) | (0xffffffffu - (unsigned)idx);
}

// part[y, i] = the number of utterances of slice y (blockIdx.y) whose keys
// are above utterance i's.
__global__ void __launch_bounds__(MWD_ORDER_NT) mwd_length_rank(const int* __restrict__ lens,
                                                               int n_utt, int* __restrict__ part) {
    __shared__ unsigned long long keys[MWD_ORDER_NT];
    const int i = blockIdx.x * MWD_ORDER_NT + threadIdx.x;
    const unsigned long long my = mwd_len_key(i < n_utt ? lens[i] : 0, i);
    const int m_lo = blockIdx.y * MWD_ORDER_SLICE, m_hi = min(n_utt, m_lo + MWD_ORDER_SLICE);
    int rank = 0;
    for (int m0 = m_lo; m0 < m_hi; m0 += MWD_ORDER_NT) {
        const int m = m0 + threadIdx.x;
        keys[threadIdx.x] = m < m_hi ? mwd_len_key(lens[m], m) : 0ull;
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < MWD_ORDER_NT; ++k) rank += keys[k] > my;
        __syncthreads();
    }
    if (i < n_utt) part[(long long)blockIdx.y * n_utt + i] = rank;
}

// perm[sum over slices of part[:, i]] = i, for the thread's utterance i.
__device__ __forceinline__ void mwd_length_scatter(const int* __restrict__ part, int n_utt,
                                                   int* __restrict__ perm) {
    const int i = blockIdx.x * MWD_ORDER_NT + threadIdx.x;
    if (i >= n_utt) return;
    int rank = 0;
    for (int y = 0; y < mwd_order_slices(n_utt); ++y) rank += part[(long long)y * n_utt + i];
    perm[rank] = i;
}

// The two launches of the order: part holds N * mwd_order_slices(N) ints;
// `scatter` is a kernel whose blocks of MWD_ORDER_NT threads call
// mwd_length_scatter (with its own extra work, as the E-step's preparation).
static inline dim3 mwd_order_grid(int n) {
    return dim3((n + MWD_ORDER_NT - 1) / MWD_ORDER_NT, mwd_order_slices(n));
}
