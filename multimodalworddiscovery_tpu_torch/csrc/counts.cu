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

#include <stdint.h>

#include <mutex>

#include "counts.cuh"

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
// K4 writes, utterance-major [N, Ts, S] float32, with no transpose.
//
// What bounds it on the H100: bytes on paper (gamma read once: 47 MB at
// the dense-caption shape, 0.014 ms), but the adds decide in practice.  A
// global atomic per nonzero posterior, one thread an element, runs at about
// 20x that bound: the null states, which all emit concept 0, make 64 lanes
// of every (n, t) row at S = 128 add into the one entry counts[src[n, t],
// 0], and those adds serialise in L2.  The design takes K2's count
// consumer (counts.cuh):
// - A row (n, t) is read by a segment of SP lanes: 32 where S / W > 16,
//   else the power of two at or above S / W, so 32 / SP rows share a warp
//   (W = 4 with float4 loads of gamma and conc where S % 4 == 0, else 1);
//   a segment has 4 rows in flight, and lanes loop over k where S > 32 W.
// - The posteriors of concept 0, wherever they sit in the row, are summed
//   in registers, then over the row's lanes by shuffles, and one lane adds
//   the sum.  Every other nonzero posterior goes into the block's [F, E]
//   table in shared memory with a shared-memory atomic (the concepts of an
//   utterance's real states are distinct, so a warp's adds rarely meet).
// - The grid is persistent: up to two blocks an SM (as the table allows),
//   each over a contiguous range of rows, and each block adds its table's
//   nonzero entries into counts once, one global atomic each (K2's flush).
// - Where F x E floats do not fit in shared memory (227 KB), the same
//   kernel adds straight into counts, still with the null pre-sum: a layout
//   choice, as K4's buffers in device memory are.
// What is left is the table's adds: a float atomic in shared memory is a
// compare-and-swap loop, and at S = 12 (six real states a row) they, not
// the bytes, set the kernel's time.
// gamma is 0 wherever (t, k) is padding (the E-step's contract), so those
// elements are read and add nothing.  The order of the atomics varies
// between runs, and so do the counts' last bits.  The TPU kernel's static
// null_rows flag has no counterpart: NULL states carry concept 0 in conc.
#define MWD_K7_NT 512  // threads a block
#define MWD_K7_BPS 2   // blocks an SM at most
#define MWD_K7_U 4     // rows a segment has in flight

// Lane j of a segment of sp lanes (a power of two) holds states j W ..
// j W + W - 1 of its row, then those sp W further on, up to S.
template <bool VEC>
__global__ void __launch_bounds__(MWD_K7_NT, MWD_K7_BPS) mwd_pair_counts_rows(
    const float* __restrict__ gamma, MwdCnt c, int rows, int ts, int s, int sp, int per_block) {
    extern __shared__ float4 smem4[];
    float* tab = reinterpret_cast<float*>(smem4);
    if (c.tab_sm) mwd_cnt_zero(c, tab);
    __syncthreads();
    constexpr int W = VEC ? 4 : 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int lsp = __ffs(sp) - 1, g = 32 >> lsp, seg = lane >> lsp, j = lane & (sp - 1);
    const int r0 = blockIdx.x * per_block, r1 = min(rows, r0 + per_block);
    for (int base = r0 + warp * g * MWD_K7_U; base < r1; base += nw * g * MWD_K7_U) {
        int ph[MWD_K7_U];
        float g0[MWD_K7_U];
#pragma unroll
        for (int u = 0; u < MWD_K7_U; ++u) {
            const int r = base + u * g + seg;
            ph[u] = r < r1 ? c.src[r] : -1;
            g0[u] = 0.f;
        }
        for (int k0 = 0; k0 < s; k0 += sp * W) {
            const int k = k0 + j * W;
            float v[MWD_K7_U][W];
            int cj[MWD_K7_U][W];
#pragma unroll
            for (int u = 0; u < MWD_K7_U; ++u) {
                const int r = base + u * g + seg;
                const bool ok = r < r1 && k < s;  // VEC: k < s implies k + 3 < s
                const long long gi = (long long)r * s + k, ci = (long long)(r / ts) * s + k;
                if constexpr (VEC) {
                    const float4 g4 = ok ? *reinterpret_cast<const float4*>(gamma + gi)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
                    const int4 c4 = ok ? *reinterpret_cast<const int4*>(c.conc + ci)
                                       : make_int4(0, 0, 0, 0);
                    v[u][0] = g4.x; v[u][1] = g4.y; v[u][2] = g4.z; v[u][3] = g4.w;
                    cj[u][0] = c4.x; cj[u][1] = c4.y; cj[u][2] = c4.z; cj[u][3] = c4.w;
                } else {
                    v[u][0] = ok ? gamma[gi] : 0.f;
                    cj[u][0] = ok ? c.conc[ci] : 0;
                }
            }
#pragma unroll
            for (int u = 0; u < MWD_K7_U; ++u)
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    if (cj[u][w] == 0)
                        g0[u] += v[u][w];
                    else if (v[u][w] != 0.f)
                        mwd_cnt_add(c, tab, ph[u], cj[u][w], v[u][w]);
                }
        }
#pragma unroll
        for (int u = 0; u < MWD_K7_U; ++u) mwd_cnt_add_null(c, tab, ph[u], g0[u], j == 0, sp);
    }
    if (c.tab_sm) {
        __syncthreads();
        mwd_cnt_flush(c, tab);
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

typedef void (*MwdK7Kernel)(const float*, MwdCnt, int, int, int, int, int);

// The SMs and the blocks an SM (at most MWD_K7_BPS) of `kernel` with `smem`
// bytes of shared memory on the current device, its shared-memory opt-in
// set; queried once per (device, kernel, smem) and kept.
static int mwd_k7_occupancy(MwdK7Kernel kernel, size_t smem, int* sms, int* per_sm) {
    struct Entry {
        int dev;
        MwdK7Kernel kernel;
        size_t smem;
        int sms, per_sm;
    };
    static std::mutex mu;
    static Entry seen[16];
    static int n_seen = 0;
    int dev = 0, st = (int)cudaGetDevice(&dev);
    if (st != 0) return st;
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen; ++i) {
        const Entry& e = seen[i];
        if (e.dev == dev && e.kernel == kernel && e.smem == smem) {
            *sms = e.sms;
            *per_sm = e.per_sm;
            return 0;
        }
    }
    if ((st = mwd_smem_optin(kernel, smem)) != 0) return st;
    if ((st = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
        return st;
    if ((st = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, MWD_K7_NT,
                                                                 smem)) != 0)
        return st;
    if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *per_sm = *per_sm < MWD_K7_BPS ? *per_sm : MWD_K7_BPS;
    seen[n_seen < 16 ? n_seen++ : 15] = Entry{dev, kernel, smem, *sms, *per_sm};
    return 0;
}

extern "C" int mwd_pair_counts(const float* gamma, const int* src, const int* conc,
                               float* counts, int n, int ts, int s, int f, int e,
                               void* stream) {
    if (n < 0 || ts < 0 || s < 0 || f < 0 || e < 0) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)n * ts;
    if (rows == 0 || s == 0 || (long long)f * e == 0) return (int)cudaGetLastError();
    if (rows >= (1LL << 31) || (long long)f * e >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    MwdCnt c{src, conc, counts, f, e, 0};
    const size_t tab = (size_t)f * e * sizeof(float);
    c.tab_sm = tab <= MWD_SMEM_OPTIN_MAX;
    const size_t smem = c.tab_sm ? tab : 0;
    const bool vec = s % 4 == 0 && ((uintptr_t)gamma & 15) == 0 && ((uintptr_t)conc & 15) == 0;
    const MwdK7Kernel kernel = vec ? &mwd_pair_counts_rows<true> : &mwd_pair_counts_rows<false>;
    const int need = vec ? s / 4 : s;  // lanes a row would take
    int sp = 1;
    while (sp < need && sp < 32) sp <<= 1;
    int sms = 0, per_sm = 0;
    const int st = mwd_k7_occupancy(kernel, smem, &sms, &per_sm);
    if (st != 0) return st;
    // persistent: at most per_sm (<= 2) blocks an SM, and no block without
    // a pass of rows for each of its warps
    const long long pass = (long long)(MWD_K7_NT / 32) * (32 / sp) * MWD_K7_U;
    long long blocks = (rows + pass - 1) / pass;
    blocks = blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm;
    const int per_block = (int)((rows + blocks - 1) / blocks);
    kernel<<<(unsigned)blocks, MWD_K7_NT, smem, (cudaStream_t)stream>>>(gamma, c, (int)rows, ts,
                                                                       s, sp, per_block);
    return (int)cudaGetLastError();
}
