// K1 (emission-table lookup) and K7 (pair counts, below).
//
// K1: emit[n, t, k] = table[src[n, t], conc[n, k]].
//
// Replaces multimodalworddiscovery_tpu/ops/counts_pallas.py:
// table_lookup_pallas (_lookup_kernel), which did the lookup as a one-hot
// MXU matmul plus per-lane masked selects in the TPU's lane-major layout.
// On the H100 it is a gather into the utterance-major [N, Ts, S] output,
// bound by the bytes it writes (N Ts S floats; the ids and the table are
// small).  The design:
// - A persistent grid of a few blocks an SM (K7's pattern), each over a
//   contiguous range of utterances, taken a chunk at a time: the chunk's
//   src rows and conc rows are staged in shared memory, then its output,
//   one contiguous range of chunk Ts S floats, is written with 16-byte
//   stores (scalar ones at the range's unaligned head and tail).
// - Index math in 32 bits inside the chunk, from one 64-bit base: the
//   (utterance, t, k) of an element by a float reciprocal and one
//   correction (exact below 2^24), stepped across a store's four elements.
// - The table in shared memory where it fits and the chunks' output
//   outweighs loading it (12 KB at the headline, 51 KB at the VQ teacher,
//   78 KB at the dense captions); otherwise read through __ldg, a layout
//   choice.
// An id outside the table yields NaN, so a bad corpus poisons the
// log-likelihood instead of reading out of bounds; the result is the plain
// gather's, bit for bit.

#include <stdint.h>

#include <mutex>

#include "counts.cuh"

#define MWD_K1_NT 256
#define MWD_K1_BPS 4        // blocks an SM at most
#define MWD_K1_STAGE 8192   // ints of a chunk's staged src and conc rows (32 KB)
#define MWD_K1_FLAT (1 << 24)  // elements a chunk: the reciprocal division is exact below

// x / d for 0 <= x < 2^24 and d >= 1, with inv = 1 / d (or by integer
// division where the chunk is longer: exact).
__device__ __forceinline__ int mwd_k1_div(int x, int d, float inv, bool exact) {
    if (exact) return x / d;
    int q = __float2int_rz((float)x * inv);
    const int r = x - q * d;
    q += r < 0 ? -1 : (r >= d ? 1 : 0);
    return q;
}

// TAB: the table in shared memory; STAGED: the chunk's id rows too (else
// read from device memory: rows longer than the staging area).
template <bool TAB, bool STAGED>
__global__ void __launch_bounds__(MWD_K1_NT) mwd_table_lookup_kernel(
    const float* __restrict__ table,  // [F, E]
    const int* __restrict__ src,      // [N, Ts]
    const int* __restrict__ conc,     // [N, S]
    float* __restrict__ out,          // [N, Ts, S]
    int n, int ts, int s, int f, int e, int per_block, int chunk) {
    extern __shared__ float4 smem4[];
    float* tab = reinterpret_cast<float*>(smem4);
    int* st = reinterpret_cast<int*>(tab + (TAB ? (f * e + 3) / 4 * 4 : 0));  // [chunk][ts]
    int* ct = st + chunk * ts;                                                // [chunk][s]
    const int tid = threadIdx.x;
    if constexpr (TAB) {
        const int fe = f * e;
        if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
            for (int q = tid; q < fe / 4; q += MWD_K1_NT)
                reinterpret_cast<float4*>(tab)[q] = __ldg(reinterpret_cast<const float4*>(table) + q);
            for (int q = fe / 4 * 4 + tid; q < fe; q += MWD_K1_NT) tab[q] = __ldg(table + q);
        } else {
            for (int q = tid; q < fe; q += MWD_K1_NT) tab[q] = __ldg(table + q);
        }
    }
    const int len = ts * s;
    const float inv_s = 1.f / (float)s, inv_len = 1.f / (float)len;
    const bool exact = (long long)chunk * len > MWD_K1_FLAT;
    const int n0 = blockIdx.x * per_block, n1 = min(n, n0 + per_block);
    for (int c0 = n0; c0 < n1; c0 += chunk) {
        const int cu = min(chunk, n1 - c0);
        const int* sr = src + (long long)c0 * ts;
        const int* cr = conc + (long long)c0 * s;
        if constexpr (STAGED) {
            __syncthreads();  // the previous chunk's readers are done
            for (int q = tid; q < cu * ts; q += MWD_K1_NT) st[q] = __ldg(sr + q);
            for (int q = tid; q < cu * s; q += MWD_K1_NT) ct[q] = __ldg(cr + q);
        }
        __syncthreads();  // the ids (and, the first time, the table) are in
        auto value = [&](int u, int t, int k) -> float {
            const int ph = STAGED ? st[u * ts + t] : __ldg(sr + u * ts + t);
            const int cj = STAGED ? ct[u * s + k] : __ldg(cr + u * s + k);
            if (ph < 0 || ph >= f || cj < 0 || cj >= e) return NAN;
            return TAB ? tab[ph * e + cj] : __ldg(table + (long long)ph * e + cj);
        };
        auto at = [&](int x, int& u, int& t, int& k) {
            u = mwd_k1_div(x, len, inv_len, exact);
            const int r = x - u * len;
            t = mwd_k1_div(r, s, inv_s, exact);
            k = r - t * s;
        };
        float* dst = out + (long long)c0 * len;
        const int total = cu * len;
        const int head = min(total, (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
        const int nv = (total - head) / 4;
        for (int x = tid; x < head; x += MWD_K1_NT) {
            int u, t, k;
            at(x, u, t, k);
            dst[x] = value(u, t, k);
        }
        for (int v = tid; v < nv; v += MWD_K1_NT) {
            const int x = head + 4 * v;
            int u, t, k;
            at(x, u, t, k);
            float o[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                o[w] = value(u, t, k);
                if (++k == s) {
                    k = 0;
                    if (++t == ts) {
                        t = 0;
                        ++u;
                    }
                }
            }
            *reinterpret_cast<float4*>(dst + x) = make_float4(o[0], o[1], o[2], o[3]);
        }
        for (int x = head + 4 * nv + tid; x < total; x += MWD_K1_NT) {
            int u, t, k;
            at(x, u, t, k);
            dst[x] = value(u, t, k);
        }
    }
}

// The SMs and the blocks an SM (at most cap) of `kernel` with `nt` threads
// and `smem` bytes of shared memory on the current device; queried once per
// (device, kernel, smem) and kept.  The kernel's opt-in is set to the whole
// 227 KB, so a launch of any size after a cached query finds it set.
template <typename Kernel>
static int mwd_occupancy(Kernel kernel, int nt, size_t smem, int cap, int* sms, int* per_sm) {
    struct Entry {
        int dev;
        Kernel kernel;
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
        const Entry& en = seen[i];
        if (en.dev == dev && en.kernel == kernel && en.smem == smem) {
            *sms = en.sms;
            *per_sm = en.per_sm;
            return 0;
        }
    }
    if ((st = mwd_smem_optin(kernel, MWD_SMEM_OPTIN_MAX)) != 0) return st;
    *sms = mwd_sms();
    if ((st = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, nt, smem)) != 0)
        return st;
    if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *per_sm = *per_sm < cap ? *per_sm : cap;
    seen[n_seen < 16 ? n_seen++ : 15] = Entry{dev, kernel, smem, *sms, *per_sm};
    return 0;
}

typedef void (*MwdK1Kernel)(const float*, const int*, const int*, float*, int, int, int, int, int,
                            int, int);

extern "C" int mwd_table_lookup(const float* table, const int* src, const int* conc,
                                float* out, int n, int ts, int s, int f, int e,
                                void* stream) {
    if (n < 0 || ts < 0 || s < 0 || f < 0 || e < 0) return (int)cudaErrorInvalidValue;
    if ((long long)n * ts * s == 0) return (int)cudaGetLastError();
    if ((long long)ts * s >= (1LL << 31) || (long long)f * e >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const long long len = (long long)ts * s;
    const bool staged = ts + s <= MWD_K1_STAGE;
    // a chunk: as many utterances as the staging area holds, its flat index
    // below 2^31 (and below 2^24 where one utterance allows, for the
    // reciprocal division)
    long long chunk = staged ? MWD_K1_STAGE / (ts + s) : n;
    const long long flat = len < MWD_K1_FLAT ? MWD_K1_FLAT : (1LL << 31) - 1;
    if (chunk > flat / len) chunk = flat / len;
    if (chunk < 1) chunk = 1;
    // first a grid of up to MWD_K1_BPS blocks an SM without the table, to
    // learn the SMs; the table goes to shared memory if it fits and the
    // blocks' output is at least twice its size
    int sms = 0, per_sm = 0;
    const size_t ids = staged ? sizeof(int) * (size_t)chunk * (ts + s) : 0;
    MwdK1Kernel kernel = staged ? &mwd_table_lookup_kernel<false, true>
                                : &mwd_table_lookup_kernel<false, false>;
    int st = mwd_occupancy(kernel, MWD_K1_NT, ids, MWD_K1_BPS, &sms, &per_sm);
    if (st != 0) return st;
    long long blocks = n < (long long)sms * per_sm ? n : (long long)sms * per_sm;
    const size_t tab = sizeof(float) * (((size_t)f * e + 3) / 4 * 4);
    size_t smem = ids;
    if (tab + ids <= MWD_SMEM_OPTIN_MAX && (long long)f * e * 2 <= (n + blocks - 1) / blocks * len) {
        MwdK1Kernel k_tab = staged ? &mwd_table_lookup_kernel<true, true>
                                   : &mwd_table_lookup_kernel<true, false>;
        if ((st = mwd_occupancy(k_tab, MWD_K1_NT, tab + ids, MWD_K1_BPS, &sms, &per_sm)) != 0)
            return st;
        kernel = k_tab;
        smem = tab + ids;
        blocks = n < (long long)sms * per_sm ? n : (long long)sms * per_sm;
    }
    const int per_block = (int)((n + blocks - 1) / blocks);
    blocks = (n + per_block - 1) / per_block;
    kernel<<<(unsigned)blocks, MWD_K1_NT, smem, (cudaStream_t)stream>>>(
        table, src, conc, out, n, ts, s, f, e, per_block, (int)chunk);
    return (int)cudaGetLastError();
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

typedef void (*MwdK7Kernel)(const float*, MwdCnt, int, int, int, int, int);

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
    const int st = mwd_occupancy(kernel, MWD_K7_NT, smem, MWD_K7_BPS, &sms, &per_sm);
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
