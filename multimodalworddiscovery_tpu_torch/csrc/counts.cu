// K1 (emission-table lookup) and K7 (pair counts, below).
//
// K1: emit[n, t, k] = table[src[n, t], conc[n, k]].
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

// K7: expected (phone, concept) pair counts from the state posteriors,
// counts[f, e] = sum over (n, t, k) of gamma[n, t, k] [src[n, t] = f] [conc[n, k] = e].
//
// Replaces multimodalworddiscovery_tpu/ops/counts_pallas.py:
// pair_counts_pallas (_counts_kernel), which contracted one-hot matrices on
// the MXU over the TPU's padded time-major [Tp, Kp, Np] layout into one
// partial [F, E] table per batch block.  Here it reads gamma in the layout
// K4 writes, utterance-major [N, Ts, S] float32, one thread per element
// (consecutive threads on consecutive k of one (n, t) row, so the reads are
// coalesced), and each nonzero posterior goes into counts with one
// atomicAdd, as K2's count half does.  gamma is 0 wherever (t, k) is
// padding (the E-step's contract), so those elements are read and skipped.
// Nothing lives in shared memory, so it takes every shape K4 does and any
// V_src, V_trg.  It is bound by bytes on paper (gamma read once); in
// practice the atomics' throughput in L2 may bound it, since the paired
// NULL states of one (n, t) row all add into counts[src, 0].  Atomics make
// the order of the sums vary between runs.  The TPU kernel's static
// null_rows flag has no counterpart: NULL states carry concept 0 in conc.
__global__ void mwd_pair_counts_kernel(
    const float* __restrict__ gamma,  // [N, Ts, S]
    const int* __restrict__ src,      // [N, Ts]
    const int* __restrict__ conc,     // [N, S]
    float* __restrict__ counts,       // [F, E], zeroed
    long long total, int ts, int s, int f, int e) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const float g = gamma[i];
        if (g == 0.f) continue;
        const int k = (int)(i % s);
        const long long nt = i / s;
        const long long n = nt / ts;
        const int ph = src[nt];
        const int c = conc[n * s + k];
        // ids are validated when the corpus is built; an id outside the
        // table already made K1's emission NaN
        if (ph >= 0 && ph < f && c >= 0 && c < e) atomicAdd(&counts[(long long)ph * e + c], g);
    }
}

static long long mwd_counts_blocks(long long total, int threads) {
    const long long blocks = (total + threads - 1) / threads;
    return blocks > 132LL * 32 ? 132LL * 32 : blocks;  // grid-stride beyond this
}

extern "C" int mwd_table_lookup(const float* table, const int* src, const int* conc,
                                float* out, int n, int ts, int s, int f, int e,
                                void* stream) {
    const long long total = (long long)n * ts * s;
    if (total == 0) return (int)cudaGetLastError();
    const int threads = 256;
    mwd_table_lookup_kernel<<<(unsigned)mwd_counts_blocks(total, threads), threads, 0,
                              (cudaStream_t)stream>>>(table, src, conc, out, total, ts, s, f, e);
    return (int)cudaGetLastError();
}

extern "C" int mwd_pair_counts(const float* gamma, const int* src, const int* conc,
                               float* counts, int n, int ts, int s, int f, int e,
                               void* stream) {
    const long long total = (long long)n * ts * s;
    if (total == 0) return (int)cudaGetLastError();
    const int threads = 256;
    mwd_pair_counts_kernel<<<(unsigned)mwd_counts_blocks(total, threads), threads, 0,
                             (cudaStream_t)stream>>>(gamma, src, conc, counts, total, ts, s, f, e);
    return (int)cudaGetLastError();
}
