// K1: emission-table lookup, emit[n, t, k] = table[src[n, t], conc[n, k]].
//
// Replaces multimodalworddiscovery_tpu/ops/counts_pallas.py:
// table_lookup_pallas (_lookup_kernel), which did the lookup as a one-hot
// MXU matmul plus per-lane masked selects in the TPU's lane-major layout.
// On the H100 it is a gather: one thread per output element, utterance-major
// [N, Ts, S] output.  It is bound by memory (it writes N*Ts*S floats and
// reads a table that stays in L1/L2), so the design only keeps the stores
// coalesced: consecutive threads write consecutive k of one (n, t) row.
// An id outside the table yields NaN, so a bad corpus poisons the
// log-likelihood instead of reading out of bounds.

#include "common.cuh"

__global__ void mwd_table_lookup_kernel(
    const float* __restrict__ table,  // [F, E]
    const int* __restrict__ src,      // [N, Ts]
    const int* __restrict__ conc,     // [N, S]
    float* __restrict__ out,          // [N, Ts, S]
    long long total, int ts, int s, int f, int e) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int k = (int)(i % s);
        const long long nt = i / s;
        const long long n = nt / ts;
        const int ph = src[nt];
        const int c = conc[n * s + k];
        out[i] = (ph >= 0 && ph < f && c >= 0 && c < e) ? __ldg(&table[ph * e + c]) : NAN;
    }
}

extern "C" int mwd_table_lookup(const float* table, const int* src, const int* conc,
                                float* out, int n, int ts, int s, int f, int e,
                                void* stream) {
    const long long total = (long long)n * ts * s;
    if (total == 0) return (int)cudaGetLastError();
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
    mwd_table_lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        table, src, conc, out, total, ts, s, f, e);
    return (int)cudaGetLastError();
}
