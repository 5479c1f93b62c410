// The E-step machinery shared by K4 and K6 (hmm_estep.cu) and K2
// (hmm_estep_counts.cu): the preparation (length order and table), the
// forward and the backward of the warp path (S <= 32) and of the block path
// (S > 32) as __device__ bodies, and the launch planning.  Each source wraps
// the bodies in __global__ kernels of its own names, so a profile tells K2's
// device time from K4's, and instantiates only what it launches.  The
// design is described at the top of hmm_estep.cu; the backward's CNT flag
// is K2's counts consumer (MwdCnt, counts.cuh) in place of the gamma store.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "counts.cuh"
#include "order.cuh"

#define MWD_FULL 0xffffffffu
#define MWD_NT 256          // threads of a block-path block
#define MWD_B 4             // utterances of a block-path block (8 for large batches)
#define MWD_B8_MIN_UTT 2048 // batch from which S <= 64 blocks take 8 utterances
#define MWD_WARPS 4         // warps of a warp-path block
#define MWD_TC_MAX 16       // steps in xi's chunk buffer
#define MWD_XREG_TILES 4    // most 4 x 4 xi tiles a thread keeps in registers
#define MWD_REMAT_MAX_TC 64 // K6's longest chunk (a warp-path lane's local array)
#define MWD_RING 3          // prefetch ring depth (rows two steps ahead)
#define MWD_XI_SLICES 64    // first pass of the xi reduction over many blocks

__device__ __forceinline__ float mwd_guard(float m) { return m > MWD_NEG_INF / 2 ? m : 0.f; }

// Max over the SP lanes of a segment (xor offsets stay inside it; the sum
// is common.cuh's mwd_warp_sum).
template <int SP>
__device__ __forceinline__ float mwd_seg_max(float v) {
#pragma unroll
    for (int o = SP / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(MWD_FULL, v, o));
    return v;
}

__device__ __forceinline__ void mwd_cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
// A row element into a block buffer: cp.async into shared memory, or a
// plain copy where the buffers live in device memory (GLOB).
template <bool GLOB>
__device__ __forceinline__ void mwd_copy4(float* dst, const float* src) {
    if constexpr (GLOB)
        *dst = *src;
    else
        mwd_cp_async4(dst, src);
}
__device__ __forceinline__ void mwd_cp_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void mwd_cp_wait2() { asm volatile("cp.async.wait_group 2;\n"); }

// ---------------------------------------------------------------------------
// Preparation, MWD_ORDER_NT threads a block, one block per MWD_ORDER_NT
// utterances, after mwd_length_rank: the length order (order.cuh), and in
// block 0 the table: ws[0, S^2) = exp(base0) in float32, ws[S^2, 2 S^2)
// the same rounded to bf16 (bf16) or copied, ws[2 S^2] = max(base).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mwd_prep_body(const float* __restrict__ base,
                                              const int* __restrict__ part, int n_utt, int s,
                                              int bf16, float* __restrict__ ws,
                                              int* __restrict__ perm) {
    __shared__ float red[32];
    mwd_length_scatter(part, n_utt, perm);
    if (blockIdx.x != 0) return;
    const int ss = s * s;
    float mb = -INFINITY;
    for (int k = threadIdx.x; k < ss; k += MWD_ORDER_NT) mb = fmaxf(mb, base[k]);
    mb = mwd_block_max(mb, red);
    for (int k = threadIdx.x; k < ss; k += MWD_ORDER_NT) {
        const float v = expf(fmaxf(base[k] - mb, MWD_NEG_INF));
        ws[k] = v;
        ws[ss + k] = bf16 ? mwd_dot_in<true>(v) : v;
    }
    if (threadIdx.x == 0) ws[2 * ss] = mb;
}

// xi reduction: dst[p, i] = mul[i] (if given) * sum over rows r of slice p
// of src[r, i], rows split into gridDim.y slices; the sums run in a fixed
// order, so xi is the same from run to run.
__device__ __forceinline__ void mwd_xi_reduce_body(const float* __restrict__ src, int rows,
                                                   int cols, const float* __restrict__ mul,
                                                   float* __restrict__ dst) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cols) return;
    const int per = (rows + gridDim.y - 1) / gridDim.y;
    const int r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int r = r0;
    for (; r + 4 <= r1; r += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += src[(long long)(r + u) * cols + i];
    for (; r < r1; ++r) acc[0] += src[(long long)r * cols + i];
    const float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    dst[(long long)blockIdx.y * cols + i] = mul ? mul[i] * v : v;
}

// ---------------------------------------------------------------------------
// The warp path (S <= 32): 32 / SP utterances a warp, lane j of a segment
// holds state j.  Each warp sweeps to the longest of its utterances.
// ---------------------------------------------------------------------------

// One forward step: alpha'[j] = log(sum_k T[k, j] e[k]) + m + emit[t, j] +
// colmask[j], e = exp(alpha - rowz0 - m); carried where !alive.  tcol holds
// column j of T as the product reads it.  Shared by K4's forward and K6's
// recomputation, so both give the same alphas.
template <int SP, bool BF16>
__device__ __forceinline__ float mwd_warp_fwd_step(const float (&tcol)[SP], float alpha,
                                                   float rz, float cm, float em_t, bool alive,
                                                   bool act) {
    const float a2 = act ? alpha - rz : -INFINITY;
    const float ms = mwd_guard(mwd_seg_max<SP>(a2));
    const float e = act ? mwd_dot_in<BF16>(expf(a2 - ms)) : 0.f;
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < SP; ++k) p = fmaf(tcol[k], __shfl_sync(MWD_FULL, e, k, SP), p);
    float upd = p > 0.f ? logf(fmaxf(p, 1e-38f)) + ms : MWD_NEG_INF;
    upd = upd + em_t + cm;
    return (act && alive) ? upd : alpha;
}

// The utterance of this lane's segment (n = -1 past the batch), its length
// and the warp's longest length.
struct MwdLaneUtt {
    int n, len, tmax;
};

template <int SP>
__device__ __forceinline__ MwdLaneUtt mwd_lane_utt(const int* lens, const int* perm, int n_utt) {
    const int lane = threadIdx.x & 31;
    const int u = (blockIdx.x * MWD_WARPS + (threadIdx.x >> 5)) * (32 / SP) + lane / SP;
    MwdLaneUtt r;
    r.n = u < n_utt ? perm[u] : -1;
    r.len = r.n >= 0 ? lens[r.n] : 0;
    r.tmax = r.len;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r.tmax = max(r.tmax, __shfl_xor_sync(MWD_FULL, r.tmax, o));
    return r;
}

// Forward: alphas [N, Ts, S] (rows t < the warp's longest length), or with
// CKPT only ckpt [N, n_chunks, S], ckpt[c] = alpha[c * tcr - 1] (chunk 0:
// alpha[0]); and logZ.
#define MWD_FWD_PARAMS                                                                     \
    const float *__restrict__ ws, const float *__restrict__ init,                          \
        const float *__restrict__ rowz, const float *__restrict__ colmask,                 \
        const float *__restrict__ emit, const int *__restrict__ lens,                      \
        const int *__restrict__ perm, float *__restrict__ out, float *__restrict__ logz,   \
        int n_utt, int ts, int s, int tcr
#define MWD_FWD_NAMES ws, init, rowz, colmask, emit, lens, perm, out, logz, n_utt, ts, s, tcr

template <int SP, bool BF16, bool CKPT>
__device__ __forceinline__ void mwd_fwd_warp_body(MWD_FWD_PARAMS) {
    const int j = (threadIdx.x & 31) % SP;
    const MwdLaneUtt ut = mwd_lane_utt<SP>(lens, perm, n_utt);
    const bool act = j < s && ut.n >= 0;
    const int ss = s * s;
    const float mb = ws[2 * ss];
    float tcol[SP];
#pragma unroll
    for (int k = 0; k < SP; ++k) tcol[k] = (j < s && k < s) ? ws[ss + k * s + j] : 0.f;
    const long long row = (long long)max(ut.n, 0) * s;
    const float* em = emit + row * ts;
    const float rz = act ? rowz[row + j] - mb : 0.f;
    const float cm = act ? colmask[row + j] : 0.f;
    const int n_chunks = CKPT ? (ts + tcr - 1) / tcr : 0;
    float* o = CKPT ? out + (long long)max(ut.n, 0) * n_chunks * s : out + row * ts;
    auto store = [&](int t, float a) {
        if (!act) return;
        if (!CKPT) {
            o[(long long)t * s + j] = a;
        } else {
            if (t == 0) o[j] = a;
            if ((t + 1) % tcr == 0 && t + 1 < ts) o[(long long)((t + 1) / tcr) * s + j] = a;
        }
    };
    float alpha = act ? init[row + j] + em[j] : -INFINITY;
    store(0, alpha);
    float em_next = (act && ut.tmax > 1) ? em[s + j] : 0.f;
    for (int t = 1; t < ut.tmax; ++t) {
        const float em_t = em_next;
        if (act && t + 1 < ut.tmax) em_next = em[(long long)(t + 1) * s + j];
        alpha = mwd_warp_fwd_step<SP, BF16>(tcol, alpha, rz, cm, em_t, t < ut.len, act);
        store(t, alpha);
    }
    const float m = mwd_seg_max<SP>(act ? alpha : -INFINITY);
    const float ms = mwd_guard(m);
    const float z = mwd_warp_sum(act ? expf(alpha - ms) : 0.f, SP);
    if (j == 0 && ut.n >= 0)
        logz[ut.n] = ut.len > 0 ? (m > MWD_NEG_INF / 2 ? logf(z + 1e-38f) + ms : MWD_NEG_INF)
                                : 0.f;
}

// Backward: gamma [N, Ts, S] (0 for t >= len), or with CNT K2's counts
// (the table in dynamic shared memory), and this block's partial
// sum_t ea f^T into xpart [blockIdx.x, S, S].  With REMAT the alphas come
// from the checkpoints, recomputed chunk by chunk into a local array.
#define MWD_BWD_WARP_PARAMS                                                                \
    const float *__restrict__ ws, const float *__restrict__ init,                          \
        const float *__restrict__ rowz, const float *__restrict__ colmask,                 \
        const float *__restrict__ emit, const int *__restrict__ lens,                      \
        const int *__restrict__ perm, const float *__restrict__ alph,                      \
        const float *__restrict__ logz, float *__restrict__ gamma,                         \
        float *__restrict__ xpart, int n_utt, int ts, int s, int tcr
#define MWD_BWD_WARP_NAMES \
    ws, init, rowz, colmask, emit, lens, perm, alph, logz, gamma, xpart, n_utt, ts, s, tcr

template <int SP, bool BF16, bool REMAT, bool CNT>
__device__ __forceinline__ void mwd_bwd_warp_body(MWD_BWD_WARP_PARAMS, MwdCnt cnt) {
    static_assert(!(REMAT && CNT), "K2 has no remat variant");
    __shared__ float xs[MWD_WARPS][SP][SP];
    extern __shared__ float4 smem4[];
    auto* ctab = reinterpret_cast<unsigned long long*>(smem4);  // K2's table where cnt.tab_sm
    const int lane = threadIdx.x & 31;
    const int j = lane % SP;
    const MwdLaneUtt ut = mwd_lane_utt<SP>(lens, perm, n_utt);
    const bool act = j < s && ut.n >= 0;
    const int ss = s * s;
    const float mb = ws[2 * ss];
    float trow[SP], x[SP];
#pragma unroll
    for (int k = 0; k < SP; ++k) {
        trow[k] = (j < s && k < s) ? ws[ss + j * s + k] : 0.f;
        x[k] = 0.f;
    }
    const long long row = (long long)max(ut.n, 0) * s;
    const float* em = emit + row * ts;
    float* g = gamma + row * ts;
    const float rz = act ? rowz[row + j] - mb : 0.f;
    const float cm = act ? colmask[row + j] : 0.f;
    const float lzs = mwd_guard(ut.n >= 0 ? logz[ut.n] : 0.f);
    const int len = ut.len;
    const int cj = (CNT && act) ? cnt.conc[row + j] : 0;
    const int* sr = CNT ? cnt.src + (long long)max(ut.n, 0) * ts : nullptr;
    if constexpr (CNT) {
        if (cnt.tab_sm) mwd_cnt_zero(cnt, ctab);
        __syncthreads();
    }
    float eb = MWD_NEG_INF;  // emit[t + 1] + beta[t + 1]
    auto step = [&](int t, float a_t, float em_t, int ph) {
        const float ebm = act ? eb + cm : -INFINITY;
        const float m2s = mwd_guard(mwd_seg_max<SP>(ebm));
        const float f = act ? mwd_dot_in<BF16>(expf(ebm - m2s)) : 0.f;
        const float ea = (act && t + 1 < len)
                             ? mwd_dot_in<BF16>(expf(fminf(a_t - rz - lzs + m2s, 80.f)))
                             : 0.f;
        float q = 0.f;
#pragma unroll
        for (int k = 0; k < SP; ++k) q = fmaf(trow[k], __shfl_sync(MWD_FULL, f, k, SP), q);
        float upd = q > 0.f ? logf(fmaxf(q, 1e-38f)) + m2s : MWD_NEG_INF;
        upd = upd - rz;
        const float beta = (t + 1 >= len) ? 0.f : upd;
        const float gm = t < len ? expf(fminf(a_t + beta - lzs, 0.f)) : 0.f;
        if constexpr (CNT) {
            // the null states (concept 0) share one entry: summed over the
            // segment first, then one add
            if (act && cj != 0 && gm != 0.f) mwd_cnt_add(cnt, ctab, ph, cj, gm);
            mwd_cnt_add_null(cnt, ctab, ph, (act && cj == 0) ? gm : 0.f, j == 0 && ut.n >= 0,
                             SP);
        } else if (act) {
            g[(long long)t * s + j] = gm;
        }
        eb = em_t + beta;
        // xi[k, j] += ea[k] f[j]: off the recursion's chain
#pragma unroll
        for (int k = 0; k < SP; ++k) x[k] = fmaf(__shfl_sync(MWD_FULL, ea, k, SP), f, x[k]);
    };
    if constexpr (!REMAT) {
        const float* al = alph + row * ts;
        float a_nx = 0.f, em_nx = 0.f;
        int ph_nx = 0;  // K2: the phone of the step after next, a step ahead
        if (act && ut.tmax > 0) {
            a_nx = al[(long long)(ut.tmax - 1) * s + j];
            em_nx = em[(long long)(ut.tmax - 1) * s + j];
            if constexpr (CNT) ph_nx = sr[ut.tmax - 1];
        }
        for (int t = ut.tmax - 1; t >= 0; --t) {
            const float a_t = a_nx, em_t = em_nx;
            const int ph = ph_nx;
            if (act && t > 0) {
                a_nx = al[(long long)(t - 1) * s + j];
                em_nx = em[(long long)(t - 1) * s + j];
                if constexpr (CNT) ph_nx = sr[t - 1];
            }
            step(t, a_t, em_t, ph);
        }
    } else {
        float tcol[SP];
#pragma unroll
        for (int k = 0; k < SP; ++k)
            tcol[k] = (j < s && k < s) ? ws[ss + k * s + j] : 0.f;
        const int n_chunks = (ts + tcr - 1) / tcr;
        const float* ck = alph + (long long)max(ut.n, 0) * n_chunks * s;
        float al_loc[MWD_REMAT_MAX_TC];  // alpha[c0 + i][j]
        for (int c = (ut.tmax - 1) / tcr; ut.tmax > 0 && c >= 0; --c) {
            const int c0 = c * tcr, cl = min(tcr, ut.tmax - c0);
            float alpha = act ? ck[(long long)c * s + j] : -INFINITY;
            for (int i = 0; i < cl; ++i) {
                const int t = c0 + i;
                if (t == 0) {
                    alpha = act ? init[row + j] + em[j] : -INFINITY;
                } else {
                    const float em_t = act ? em[(long long)t * s + j] : 0.f;
                    alpha = mwd_warp_fwd_step<SP, BF16>(tcol, alpha, rz, cm, em_t, t < len, act);
                }
                al_loc[i] = alpha;
            }
            for (int i = cl - 1; i >= 0; --i) {
                const int t = c0 + i;
                step(t, al_loc[i], act ? em[(long long)t * s + j] : 0.f, 0);
            }
        }
    }
    if (!CNT && act)
        for (int t = ut.tmax; t < ts; ++t) g[(long long)t * s + j] = 0.f;
    // the warp's segments into one partial, then the block's warps
#pragma unroll
    for (int o = SP; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < SP; ++k) x[k] += __shfl_xor_sync(MWD_FULL, x[k], o);
    const int w = threadIdx.x >> 5;
    if (lane < SP)
#pragma unroll
        for (int k = 0; k < SP; ++k) xs[w][k][lane] = x[k];
    __syncthreads();
    float* xp = xpart + (long long)blockIdx.x * ss;
    for (int i = threadIdx.x; i < ss; i += blockDim.x) {
        const int k = i / s, jj = i % s;
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < MWD_WARPS; ++ww) v += xs[ww][k][jj];
        xp[i] = v;
    }
    if constexpr (CNT)
        if (cnt.tab_sm) mwd_cnt_flush(cnt, ctab);  // every add is in: the barrier above
}

// ---------------------------------------------------------------------------
// The block path (S > 32): MWD_NT threads and B utterances a block, B = 4,
// or 8 where S <= 64 and the batch is large enough to fill the card with
// blocks of 8 (each step's latency then serves twice the work).
// ---------------------------------------------------------------------------

// Shared-memory layout of a block-path kernel, in floats (every region a
// multiple of 4, so float4 reads stay aligned).
struct MwdLayout {
    int sp, ks, s4, ld;  // table row stride (odd), product split, S rounded up to
                         // 4, xi's chunk row stride (4 mod 32: its tensor-core
                         // fragment reads are free of bank conflicts)
    int e, p, a, rz, cm, emr, alr, aa, ea, fc, tab, cj, cnt, total;
};

__host__ __device__ inline int mwd_up4(int x) { return (x + 3) & ~3; }

// K splits of a step's product: none for the float32 product (one chain
// over k, mwd_blk_product); the bf16 product's 16-row tiles split so every
// warp has one.
__host__ __device__ inline int mwd_ks(int s, bool bf16) {
    if (!bf16) return 1;
    const int mt = (s + 15) / 16, ks = (MWD_NT / 32) / mt;
    return ks < 1 ? 1 : ks;
}

// counts: K2's backward (conc ids of the block's utterances), with a count
// table of cnt 64-bit entries in shared memory (0: in device memory).
__host__ __device__ inline MwdLayout mwd_layout(int s, int tc, bool tab_sm, bool bwd,
                                                bool remat, int b, bool bf16,
                                                bool counts = false, int cnt = 0) {
    MwdLayout L;
    L.sp = s | 1;
    L.ks = mwd_ks(s, bf16);
    L.s4 = mwd_up4(s);
    L.ld = (L.s4 + 27) / 32 * 32 + 4;
    const int bs = mwd_up4(b * s);
    int o = 0;
    L.e = o;   o += bs;                  // e (forward) or f (backward) [S][B]
    L.p = o;   o += L.ks * bs;           // product partials [KS][B][S]
    L.a = o;   o += bs;                  // alpha (forward) or emit + beta (backward) [B][S]
    L.rz = o;  o += bs;                  // rowz0 [B][S]
    L.cm = o;  o += bs;                  // colmask [B][S]
    L.emr = o; o += MWD_RING * bs;       // emission rows, by t % MWD_RING
    L.alr = o; o += (bwd && !remat) ? MWD_RING * bs : 0;  // alpha rows
    L.aa = o;  o += (bwd && remat) ? bs : 0;              // K6's recomputed alpha
    L.ea = o;  o += bwd ? tc * b * L.ld : 0;              // xi's chunk: ea [TC * B][ld]
    L.fc = o;  o += bwd ? tc * b * L.ld : 0;              //             f  [TC * B][ld]
    L.tab = o; o += tab_sm ? mwd_up4(s * L.sp) : 0;       // T [S][sp]
    L.cj = o;  o += counts ? bs : 0;                      // K2: conc [B][S] (int)
    L.cnt = o; o += counts ? mwd_up4(2 * cnt) : 0;        // K2: count table (64-bit)
    L.total = o;
    return L;
}

// One step's float32 product into P [1][B][S]: the forward's p[s', b] =
// sum_k T[k, s'] E[k, b] (ROWS false: down column s'), the backward's
// q[s, b] = sum_k T[s, k] E[k, b] (ROWS true: along row s), each sum one
// FMA chain over k = 0 .. S-1, the order of the plain version's float32
// product on the card, so the two round alike (the Gaussian emissions put
// alphas near -2.4e4, where one rounding apart in a step's log shifts a
// posterior past its bound).  Item i is (bg, sc) = (i / S, i % S): state
// sc of utterances 4 bg .. 4 bg + 3, so a warp's lanes walk neighbouring
// columns or rows of T and read E [S][B] as one float4 broadcast per k.
template <int B, bool ROWS>
__device__ __forceinline__ void mwd_blk_product(const float* tab, int tsp, const float* E,
                                                float* P, int s, bool tab_sm) {
    // a table in shared memory is read with ld.shared: through the generic
    // pointer (shared or device memory) the loads would be generic
    const unsigned tab_sh = tab_sm ? (unsigned)__cvta_generic_to_shared(tab) : 0u;
    auto t_at = [&](int idx) {
        if (!tab_sm) return tab[idx];
        float v;
        asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(tab_sh + 4u * (unsigned)idx));
        return v;
    };
    for (int i = threadIdx.x; i < s * (B / 4); i += MWD_NT) {
        const int bg = i / s, sc = i - bg * s;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const float4* e4 = reinterpret_cast<const float4*>(E) + bg;
#pragma unroll 8
        for (int k = 0; k < s; ++k) {
            const float tv = ROWS ? t_at(sc * tsp + k) : t_at(k * tsp + sc);
            const float4 e = e4[k * (B / 4)];
            a0 = fmaf(tv, e.x, a0);
            a1 = fmaf(tv, e.y, a1);
            a2 = fmaf(tv, e.z, a2);
            a3 = fmaf(tv, e.w, a3);
        }
        float* pp = P + 4 * bg * s + sc;
        pp[0] = a0;
        pp[s] = a1;
        pp[2 * s] = a2;
        pp[3 * s] = a3;
    }
}

// Two bf16 values (exactly representable: the operands are rounded
// already) in one register, the lower index in the lower half.
__device__ __forceinline__ uint32_t mwd_pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 variant's step product on the tensor cores: the same partials as
// mwd_blk_product, from mma.sync.m16n8k16 (bf16 operands, float32
// accumulators).  The output [S, B] is cut into 16-row tiles (s' forward,
// s backward) of the instruction's n = 8 columns (the block's utterances;
// with B = 4 the upper four are zero), and a warp takes one tile and one of
// KS ranges of 16-deep k steps: A from the table (T^T forward, T backward),
// B from E.  The table is constant for the sweep, so where a warp has one
// tile of at most NF k steps (NF = 8: S <= 128) its A fragments stay in
// registers (MwdFrags, 4 NF of them).  wgmma is not used: its 64-row tiles
// exceed a step's product at these S.
template <int NF>
struct MwdFrags {
    uint32_t a[NF][4];
};

template <int NF>
__device__ __forceinline__ bool mwd_frags_cached(int s, int ks) {
    const int mt_n = (s + 15) / 16, ktc = (mt_n + ks - 1) / ks;
    return mt_n * ks <= MWD_NT / 32 && ktc <= NF;
}

// The A fragment of rows m0, m0 + 8 and columns k0, k0 + 1, k0 + 8, k0 + 9
// (lane (g, t4): m0 = 16 mt + g, k0 = 16 kt + 2 t4).
template <bool ROWS>
__device__ __forceinline__ void mwd_a_frag(uint32_t (&a)[4], const float* tab, int tsp, int s,
                                           int m0, int k0) {
    auto at = [&](int m, int k) {
        return (m < s && k < s) ? (ROWS ? tab[m * tsp + k] : tab[k * tsp + m]) : 0.f;
    };
    a[0] = mwd_pack_bf16(at(m0, k0), at(m0, k0 + 1));
    a[1] = mwd_pack_bf16(at(m0 + 8, k0), at(m0 + 8, k0 + 1));
    a[2] = mwd_pack_bf16(at(m0, k0 + 8), at(m0, k0 + 9));
    a[3] = mwd_pack_bf16(at(m0 + 8, k0 + 8), at(m0 + 8, k0 + 9));
}

__device__ __forceinline__ void mwd_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This warp's A fragments into registers, where mwd_frags_cached.
template <bool ROWS, int NF>
__device__ __forceinline__ void mwd_frags_load(MwdFrags<NF>& fr, const float* tab, int tsp,
                                               int s, int ks) {
    const int it = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mt_n = (s + 15) / 16, ktc = (mt_n + ks - 1) / ks;
    if (!mwd_frags_cached<NF>(s, ks) || it >= mt_n * ks) return;
    const int mt = it % mt_n, k_lo = (it / mt_n) * ktc, k_hi = min(mt_n, k_lo + ktc);
#pragma unroll
    for (int f = 0; f < NF; ++f)
        if (k_lo + f < k_hi)
            mwd_a_frag<ROWS>(fr.a[f], tab, tsp, s, mt * 16 + (lane >> 2),
                             (k_lo + f) * 16 + 2 * (lane & 3));
}

template <int B, bool ROWS, int NF>
__device__ __forceinline__ void mwd_blk_product_mma(const float* tab, int tsp, const float* E,
                                                    float* P, int s, int ks,
                                                    const MwdFrags<NF>& fr, bool use_frags) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int mt_n = (s + 15) / 16, ktc = (mt_n + ks - 1) / ks;
    const bool cached = use_frags && mwd_frags_cached<NF>(s, ks);
    auto b_at = [&](int k) { return (k < s && g < B) ? E[k * B + g] : 0.f; };
    for (int it = threadIdx.x >> 5; it < mt_n * ks; it += MWD_NT / 32) {
        const int mt = it % mt_n, kp = it / mt_n;
        const int m0 = mt * 16 + g, k_lo = kp * ktc, k_hi = min(mt_n, k_lo + ktc);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (cached) {
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                if (k_lo + f >= k_hi) break;
                const int k0 = (k_lo + f) * 16 + 2 * t4;
                mwd_mma(c, fr.a[f], mwd_pack_bf16(b_at(k0), b_at(k0 + 1)),
                        mwd_pack_bf16(b_at(k0 + 8), b_at(k0 + 9)));
            }
        } else {
            for (int kt = k_lo; kt < k_hi; ++kt) {
                const int k0 = kt * 16 + 2 * t4;
                uint32_t a[4];
                mwd_a_frag<ROWS>(a, tab, tsp, s, m0, k0);
                mwd_mma(c, a, mwd_pack_bf16(b_at(k0), b_at(k0 + 1)),
                        mwd_pack_bf16(b_at(k0 + 8), b_at(k0 + 9)));
            }
        }
        float* pp = P + kp * B * s;
        const int n0 = 2 * t4;
        if (m0 < s) {
            if (n0 < B) pp[n0 * s + m0] = c[0];
            if (n0 + 1 < B) pp[(n0 + 1) * s + m0] = c[1];
        }
        if (m0 + 8 < s) {
            if (n0 < B) pp[n0 * s + m0 + 8] = c[2];
            if (n0 + 1 < B) pp[(n0 + 1) * s + m0 + 8] = c[3];
        }
    }
}

// A step's product: on FMAs in float32, on the tensor cores in bf16 (with
// the warp's cached A fragments when use_frags).
template <int B, bool BF16, bool ROWS, int NF>
__device__ __forceinline__ void mwd_blk_step_product(const float* tab, int tsp, const float* E,
                                                     float* P, int s, int ks,
                                                     const MwdFrags<NF>& fr, bool use_frags,
                                                     bool tab_sm) {
    if constexpr (BF16)
        mwd_blk_product_mma<B, ROWS, NF>(tab, tsp, E, P, s, ks, fr, use_frags);
    else
        mwd_blk_product<B, ROWS>(tab, tsp, E, P, s, tab_sm);
}

template <int B>
__device__ __forceinline__ float mwd_partials(const float* P, int ks, int s, int b, int sc) {
    float p = 0.f;
    for (int kp = 0; kp < ks; ++kp) p += P[(kp * B + b) * s + sc];
    return p;
}

// The forward's finish of state sc of utterance b (warp b): alpha[t] from
// the product's partials, carried where !alive.  Shared by K4's forward and
// K6's recomputation.
template <int B>
__device__ __forceinline__ float mwd_blk_fwd_finish(const float* P, int ks, int s, int b,
                                                    int sc, float ms, float em_t, float cm,
                                                    float a_old, bool alive) {
    const float p = mwd_partials<B>(P, ks, s, b, sc);
    float upd = p > 0.f ? logf(fmaxf(p, 1e-38f)) + ms : MWD_NEG_INF;
    upd = upd + em_t + cm;
    return alive ? upd : a_old;
}

// The next step's exponentials e = exp(alpha - rowz0 - m) of utterance b
// (warp b) into E, from its alphas A [S]; returns the guarded maximum.
template <int B, bool BF16>
__device__ __forceinline__ float mwd_blk_exps(const float* A, const float* RZ, float* E, int s,
                                              int b) {
    const int lane = threadIdx.x & 31;
    float mx = -INFINITY;
    for (int k = lane; k < s; k += 32) mx = fmaxf(mx, A[k] - RZ[k]);
    const float ms = mwd_guard(mwd_warp_max(mx));
    for (int k = lane; k < s; k += 32) E[k * B + b] = mwd_dot_in<BF16>(expf(A[k] - RZ[k] - ms));
    return ms;
}

// The block's utterance b (perm order) or -1.
template <int B>
__device__ __forceinline__ int mwd_blk_utt(const int* perm, int n_utt, int b) {
    const int u = blockIdx.x * B + b;
    return u < n_utt ? perm[u] : -1;
}

// Common set-up: the table (in shared memory when tab_sm, with row stride
// sp; else the prepared copy in device memory), rowz0 and colmask of the
// block's utterances, and the longest length.  Returns that length.
template <int B>
__device__ __forceinline__ int mwd_blk_setup(const float* ws_tab, bool tab_sm, const MwdLayout& L,
                                             float* sm, const float** tab, int* tsp,
                                             const float* rowz, const float* colmask,
                                             const int* lens, const int* perm, int n_utt,
                                             int s, float mb) {
    if (tab_sm) {
        float* t = sm + L.tab;
        for (int i = threadIdx.x; i < s * s; i += MWD_NT) t[(i / s) * L.sp + i % s] = ws_tab[i];
        *tab = t;
        *tsp = L.sp;
    } else {
        *tab = ws_tab;
        *tsp = s;
    }
    for (int i = threadIdx.x; i < B * s; i += MWD_NT) {
        const int n = mwd_blk_utt<B>(perm, n_utt, i / s);
        const long long at = (long long)max(n, 0) * s + i % s;
        sm[L.rz + i] = n >= 0 ? rowz[at] - mb : 0.f;
        sm[L.cm + i] = n >= 0 ? colmask[at] : 0.f;
    }
    int tmax = 0;
    for (int b = 0; b < B; ++b) {
        const int n = mwd_blk_utt<B>(perm, n_utt, b);
        tmax = max(tmax, n >= 0 ? lens[n] : 0);
    }
    return tmax;
}

// Forward: alphas [N, Ts, S] (rows t < the block's longest length), or with
// CKPT only the chunk checkpoints (as the warp path's); and logZ.  GLOB: the
// block's buffers in its slice of gbuf (a template parameter, so that
// without it every buffer access stays an ld/st.shared).
template <int B, bool BF16, bool CKPT, bool GLOB>
__device__ __forceinline__ void mwd_fwd_blk_body(MWD_FWD_PARAMS, int tab_sm, float* gbuf) {
    extern __shared__ float4 smem4[];
    const MwdLayout L = mwd_layout(s, 0, tab_sm, false, false, B, BF16);
    float* sm;
    if constexpr (GLOB)
        sm = gbuf + (long long)blockIdx.x * L.total;
    else
        sm = reinterpret_cast<float*>(smem4);
    float *E = sm + L.e, *P = sm + L.p;
    const int ss = s * s, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* tab;
    int tsp;
    const int tmax = mwd_blk_setup<B>(ws + ss, tab_sm, L, sm, &tab, &tsp, rowz, colmask, lens,
                                      perm, n_utt, s, ws[2 * ss]);
    const bool owner = warp < B;  // warp b finishes utterance b
    const int n = owner ? mwd_blk_utt<B>(perm, n_utt, warp) : -1;
    const int len = n >= 0 ? lens[n] : 0;
    const long long row = (long long)max(n, 0) * s;
    const float* em = emit + row * ts;
    float *A = sm + L.a + warp * s, *RZ = sm + L.rz + warp * s, *CM = sm + L.cm + warp * s;
    const int n_chunks = CKPT ? (ts + tcr - 1) / tcr : 0;
    float* o = CKPT ? out + (long long)max(n, 0) * n_chunks * s : out + row * ts;
    auto store = [&](int t, int k, float a) {
        if (!CKPT) {
            o[(long long)t * s + k] = a;
        } else {
            if (t == 0) o[k] = a;
            if ((t + 1) % tcr == 0 && t + 1 < ts) o[(long long)((t + 1) / tcr) * s + k] = a;
        }
    };
    auto prefetch = [&](int t) {  // emission row t into the ring
        if (n >= 0 && t < tmax)
            for (int k = lane; k < s; k += 32)
                mwd_copy4<GLOB>(sm + L.emr + ((t % MWD_RING) * B + warp) * s + k,
                                em + (long long)t * s + k);
        mwd_cp_commit();
    };
    __syncthreads();  // the table, rowz0 and colmask
    MwdFrags<8> fr;
    if constexpr (BF16) mwd_frags_load<false>(fr, tab, tsp, s, L.ks);
    float ms = 0.f;
    if (owner) {
        prefetch(1);
        prefetch(2);
        if (n >= 0) {
            for (int k = lane; k < s; k += 32) {
                const float a = init[row + k] + em[k];
                A[k] = a;
                store(0, k, a);
            }
            __syncwarp();
            ms = mwd_blk_exps<B, BF16>(A, RZ, E, s, warp);
        } else {
            for (int k = lane; k < s; k += 32) E[k * B + warp] = 0.f;
        }
    }
    __syncthreads();
    for (int t = 1; t < tmax; ++t) {
        mwd_blk_step_product<B, BF16, false>(tab, tsp, E, P, s, L.ks, fr, true, tab_sm);
        __syncthreads();
        if (owner) {
            prefetch(t + 2);
            mwd_cp_wait2();
            if (n >= 0) {
                const float* er = sm + L.emr + ((t % MWD_RING) * B + warp) * s;
                for (int k = lane; k < s; k += 32) {
                    const float a = mwd_blk_fwd_finish<B>(P, L.ks, s, warp, k, ms, er[k], CM[k],
                                                          A[k], t < len);
                    A[k] = a;
                    store(t, k, a);
                }
                __syncwarp();
                ms = mwd_blk_exps<B, BF16>(A, RZ, E, s, warp);
            }
        }
        __syncthreads();
    }
    if (owner && n >= 0) {
        float mx = -INFINITY;
        for (int k = lane; k < s; k += 32) mx = fmaxf(mx, A[k]);
        const float m = mwd_warp_max(mx);
        const float m0 = mwd_guard(m);
        float z = 0.f;
        for (int k = lane; k < s; k += 32) z += expf(A[k] - m0);
        z = mwd_warp_sum(z);
        if (lane == 0)
            logz[n] = len > 0 ? (m > MWD_NEG_INF / 2 ? logf(z + 1e-38f) + m0 : MWD_NEG_INF) : 0.f;
    }
}

// Backward: gamma [N, Ts, S] (0 for t >= len) and the block's partial
// sum_t ea f^T into xpart [blockIdx.x, S, S].  A step is phase A (warp b:
// the maximum of emit + beta + colmask, f, and ea from alpha[t]; f and ea
// also into xi's chunk buffer), the product q = T f (all threads; and
// xi's chunk flush once TC steps are in), then phase C (warp b: beta,
// gamma[t], emit[t] + beta), followed at once by the next step's phase A.
// XT > 0 keeps the xi tiles in registers, XT of them a thread (1: S <= 64,
// 4: S <= 128), XT = 0 in xpart.  REMAT: K6, each chunk's alphas
// recomputed from its checkpoint into achunk [n_blocks, tcr, B, S] first.
// GLOB as in the forward.  CNT: K2, the posteriors go into the counts
// (phase C) instead of gamma.
#define MWD_BWD_BLK_PARAMS                                                                 \
    const float *__restrict__ ws, const float *__restrict__ init,                          \
        const float *__restrict__ rowz, const float *__restrict__ colmask,                 \
        const float *__restrict__ emit, const int *__restrict__ lens,                      \
        const int *__restrict__ perm, const float *__restrict__ alph,                      \
        const float *__restrict__ logz, float *__restrict__ gamma,                         \
        float *__restrict__ xpart, float *__restrict__ achunk, int n_utt, int ts, int s,   \
        int tcr, int tc, int tab_sm, float *gbuf
#define MWD_BWD_BLK_NAMES                                                                   \
    ws, init, rowz, colmask, emit, lens, perm, alph, logz, gamma, xpart, achunk, n_utt, ts, s, \
        tcr, tc, tab_sm, gbuf

template <int B, bool BF16, bool REMAT, int XT, bool GLOB, bool CNT>
__device__ __forceinline__ void mwd_bwd_blk_body(MWD_BWD_BLK_PARAMS, MwdCnt cnt) {
    static_assert(!(REMAT && CNT), "K2 has no remat variant");
    extern __shared__ float4 smem4[];
    const MwdLayout L = mwd_layout(s, tc, tab_sm, true, REMAT, B, BF16, CNT,
                                   (CNT && cnt.tab_sm) ? cnt.v_src * cnt.v_trg : 0);
    float* sm;
    if constexpr (GLOB)
        sm = gbuf + (long long)blockIdx.x * L.total;
    else
        sm = reinterpret_cast<float*>(smem4);
    float *F = sm + L.e, *Q = sm + L.p, *EA = sm + L.ea, *FC = sm + L.fc;
    const int ss = s * s, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* tab;
    int tsp;
    // the table as the products read it (rounded to bf16 with BF16); xi's
    // float32 multiply is the reduction's
    const int tmax = mwd_blk_setup<B>(ws + ss, tab_sm, L, sm, &tab, &tsp, rowz, colmask, lens,
                                      perm, n_utt, s, ws[2 * ss]);
    // the bf16 product's A fragments (loaded below); S <= 64 (XT = 1) has at
    // most 2 k steps a warp
    MwdFrags<XT == 1 ? 2 : 8> fr;
    for (int i = threadIdx.x; i < 2 * tc * B * L.ld; i += MWD_NT) EA[i] = 0.f;  // EA, FC
    for (int i = threadIdx.x; i < B * s; i += MWD_NT) {
        sm[L.a + i] = MWD_NEG_INF;  // emit[t + 1] + beta[t + 1]
        F[(i % s) * B + i / s] = 0.f;
    }
    float* xp = xpart + (long long)blockIdx.x * ss;
    if (XT == 0)
        for (int i = threadIdx.x; i < ss; i += MWD_NT) xp[i] = 0.f;
    int* CJ = reinterpret_cast<int*>(sm + L.cj);  // K2: conc of the block's utterances
    auto* ctab = reinterpret_cast<unsigned long long*>(sm + L.cnt);  // K2's, where cnt.tab_sm
    if constexpr (CNT) {
        for (int i = threadIdx.x; i < B * s; i += MWD_NT) {
            const int nb = mwd_blk_utt<B>(perm, n_utt, i / s);
            CJ[i] = nb >= 0 ? cnt.conc[(long long)nb * s + i % s] : 0;
        }
        if (cnt.tab_sm) mwd_cnt_zero(cnt, ctab);
    }
    const int nt4 = L.s4 / 4, ntiles = nt4 * nt4;
    float xr[XT > 0 ? XT : 1][16];
#pragma unroll
    for (int r = 0; r < (XT > 0 ? XT : 1); ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) xr[r][c] = 0.f;
    // X[4 ti + i, 4 tj + c] += sum over the chunk's rows of ea[i] f[c]
    auto tile = [&](float (&acc)[16], int u, int rows) {
        const int ti = u / nt4, tj = u - ti * nt4;
        const float4* ea4 = reinterpret_cast<const float4*>(EA);
        const float4* fc4 = reinterpret_cast<const float4*>(FC);
        for (int r = 0; r < rows; ++r) {
            const float4 a = ea4[r * (L.ld / 4) + ti], f = fc4[r * (L.ld / 4) + tj];
            const float av[4] = {a.x, a.y, a.z, a.w}, fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i * 4 + c] = fmaf(av[i], fv[c], acc[i * 4 + c]);
        }
    };
    // bf16 with the accumulator in registers: the chunk's product on the
    // tensor cores, C tiles of 16 states x 8 states, 4 XT of them a warp
    // (tile u = warp + 8 i), A = ea^T and B = f from the chunk buffers
    // (rows past `rows` read as 0); xr[r] holds tiles 4 r .. 4 r + 3.
    const int mt_n = (s + 15) / 16, n8 = (s + 7) / 8, lg = lane >> 2, lt = lane & 3;
    auto flush_mma = [&](int rows) {
        auto ea_at = [&](int r, int k) { return (r < rows && k < s) ? EA[r * L.ld + k] : 0.f; };
        auto fc_at = [&](int r, int j) { return (r < rows && j < s) ? FC[r * L.ld + j] : 0.f; };
        // k steps outside, tiles inside: tiles of one row (or column) block
        // read the same fragment, with no store between the reads
        for (int r0 = 2 * lt; r0 - 2 * lt < rows; r0 += 16) {
#pragma unroll
            for (int i = 0; i < 4 * (XT > 0 ? XT : 1); ++i) {
                const int u = warp + (MWD_NT / 32) * i;
                if (u >= mt_n * n8) break;
                const int m0 = (u / n8) * 16 + lg, j = (u % n8) * 8 + lg;
                const uint32_t a[4] = {mwd_pack_bf16(ea_at(r0, m0), ea_at(r0 + 1, m0)),
                                       mwd_pack_bf16(ea_at(r0, m0 + 8), ea_at(r0 + 1, m0 + 8)),
                                       mwd_pack_bf16(ea_at(r0 + 8, m0), ea_at(r0 + 9, m0)),
                                       mwd_pack_bf16(ea_at(r0 + 8, m0 + 8), ea_at(r0 + 9, m0 + 8))};
                float c[4] = {xr[i / 4][4 * (i % 4)], xr[i / 4][4 * (i % 4) + 1],
                              xr[i / 4][4 * (i % 4) + 2], xr[i / 4][4 * (i % 4) + 3]};
                mwd_mma(c, a, mwd_pack_bf16(fc_at(r0, j), fc_at(r0 + 1, j)),
                        mwd_pack_bf16(fc_at(r0 + 8, j), fc_at(r0 + 9, j)));
#pragma unroll
                for (int q = 0; q < 4; ++q) xr[i / 4][4 * (i % 4) + q] = c[q];
            }
        }
    };
    auto flush = [&](int rows) {
        if constexpr (BF16 && XT > 0) {
            flush_mma(rows);
        } else if constexpr (XT > 0) {
#pragma unroll
            for (int r = 0; r < XT; ++r) {
                const int u = threadIdx.x + r * MWD_NT;
                if (u < ntiles) tile(xr[r], u, rows);
            }
        } else {
            for (int u = threadIdx.x; u < ntiles; u += MWD_NT) {
                const int ti = u / nt4, tj = u - ti * nt4;
                float acc[16];
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    const int k = 4 * ti + c / 4, jj = 4 * tj + c % 4;
                    acc[c] = (k < s && jj < s) ? xp[k * s + jj] : 0.f;
                }
                tile(acc, u, rows);
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    const int k = 4 * ti + c / 4, jj = 4 * tj + c % 4;
                    if (k < s && jj < s) xp[k * s + jj] = acc[c];
                }
            }
        }
    };

    const bool owner = warp < B;
    const int n = owner ? mwd_blk_utt<B>(perm, n_utt, warp) : -1;
    const int len = n >= 0 ? lens[n] : 0;
    const float lzs = mwd_guard(n >= 0 ? logz[n] : 0.f);
    const long long row = (long long)max(n, 0) * s;
    const float* em = emit + row * ts;
    float* g = gamma + row * ts;
    float *EB = sm + L.a + warp * s, *RZ = sm + L.rz + warp * s, *CM = sm + L.cm + warp * s;
    float* ac = REMAT ? achunk + (long long)blockIdx.x * tcr * B * s : nullptr;
    auto slot = [&](int t) { return ((t % MWD_RING) * B + warp) * s; };
    auto prefetch = [&](int t) {  // emission (and alpha) rows t into the rings
        if (n >= 0 && t >= 0)
            for (int k = lane; k < s; k += 32) {
                mwd_copy4<GLOB>(sm + L.emr + slot(t) + k, em + (long long)t * s + k);
                if (!REMAT)
                    mwd_copy4<GLOB>(sm + L.alr + slot(t) + k,
                                    alph + row * ts + (long long)t * s + k);
            }
        mwd_cp_commit();
    };
    auto alpha_at = [&](int t, int k) {
        if constexpr (REMAT) return ac[((t % tcr) * B + warp) * s + k];
        return sm[L.alr + slot(t) + k];
    };
    float m2s = 0.f;
    int fill = 0;  // steps in xi's chunk buffer
    int ph = 0;    // K2: the phone at step t, loaded in phase A for phase C
    auto phase_a = [&](int t) {
        prefetch(t - 2);
        mwd_cp_wait2();
        if (n < 0) return;
        if constexpr (CNT) ph = cnt.src[(long long)n * ts + t];
        float mx = -INFINITY;
        for (int k = lane; k < s; k += 32) mx = fmaxf(mx, EB[k] + CM[k]);
        m2s = mwd_guard(mwd_warp_max(mx));
        float* ear = EA + (fill * B + warp) * L.ld;
        float* fcr = FC + (fill * B + warp) * L.ld;
        for (int k = lane; k < s; k += 32) {
            const float f = mwd_dot_in<BF16>(expf(EB[k] + CM[k] - m2s));
            F[k * B + warp] = f;
            fcr[k] = f;
            ear[k] = t + 1 < len
                         ? mwd_dot_in<BF16>(expf(fminf(alpha_at(t, k) - RZ[k] - lzs + m2s, 80.f)))
                         : 0.f;
        }
    };
    auto phase_c = [&](int t) {
        if (n < 0) return;
        float g0 = 0.f;  // K2: the null states' posteriors (concept 0, one entry)
        for (int k = lane; k < s; k += 32) {
            const float q = mwd_partials<B>(Q, L.ks, s, warp, k);
            float upd = q > 0.f ? logf(fmaxf(q, 1e-38f)) + m2s : MWD_NEG_INF;
            upd = upd - RZ[k];
            const float beta = (t + 1 >= len) ? 0.f : upd;
            const float a_t = alpha_at(t, k);
            const float gm = t < len ? expf(fminf(a_t + beta - lzs, 0.f)) : 0.f;
            if constexpr (CNT) {
                const int cj = CJ[warp * s + k];
                if (cj == 0)
                    g0 += gm;
                else if (gm != 0.f)
                    mwd_cnt_add(cnt, ctab, ph, cj, gm);
            } else {
                g[(long long)t * s + k] = gm;
            }
            EB[k] = sm[L.emr + slot(t) + k] + beta;
        }
        if constexpr (CNT) mwd_cnt_add_null(cnt, ctab, ph, g0, lane == 0, 32);
    };
    // K6: alphas of chunk c (t in [c0, c0 + cl)) into ac, from checkpoint c
    // (alpha[c0 - 1]) or, for c = 0, from init + emit[0]; F and Q serve as
    // the forward's E and P.
    auto recompute = [&](int c) {
        if constexpr (REMAT) {
            const int c0 = c * tcr, cl = min(tcr, tmax - c0);
            float* AA = sm + L.aa + warp * s;
            const float* ck = alph + (long long)max(n, 0) * ((ts + tcr - 1) / tcr) * s;
            float ms = 0.f;
            if (owner && n >= 0) {
                for (int k = lane; k < s; k += 32) {
                    const float a = c == 0 ? init[row + k] + em[k] : ck[(long long)c * s + k];
                    AA[k] = a;
                    if (c == 0) ac[warp * s + k] = a;
                }
                __syncwarp();
                ms = mwd_blk_exps<B, BF16>(AA, RZ, F, s, warp);
            }
            __syncthreads();
            for (int t = c == 0 ? 1 : c0; t < c0 + cl; ++t) {
                mwd_blk_step_product<B, BF16, false>(tab, tsp, F, Q, s, L.ks, fr, false, tab_sm);
                __syncthreads();
                if (owner && n >= 0) {
                    for (int k = lane; k < s; k += 32) {
                        const float a = mwd_blk_fwd_finish<B>(Q, L.ks, s, warp, k, ms,
                                                              em[(long long)t * s + k], CM[k],
                                                              AA[k], t < len);
                        AA[k] = a;
                        ac[((t - c0) * B + warp) * s + k] = a;
                    }
                    __syncwarp();
                    ms = mwd_blk_exps<B, BF16>(AA, RZ, F, s, warp);
                }
                __syncthreads();
            }
        }
    };

    __syncthreads();  // the table, rowz0, colmask, the zeroed buffers
    if constexpr (BF16) mwd_frags_load<true>(fr, tab, tsp, s, L.ks);
    if (owner) {
        prefetch(tmax - 1);
        prefetch(tmax - 2);
    }
    for (int t = tmax - 1; t >= 0; --t) {
        if (t == tmax - 1 || (REMAT && (t + 1) % tcr == 0)) {
            recompute(t / tcr);
            if (owner) phase_a(t);
            __syncthreads();
        }
        mwd_blk_step_product<B, BF16, true>(tab, tsp, F, Q, s, L.ks, fr, true, tab_sm);
        if (++fill == tc || t == 0) {
            flush(fill * B);
            fill = 0;
        }
        __syncthreads();
        if (owner) {
            phase_c(t);
            if (t > 0 && !(REMAT && t % tcr == 0)) phase_a(t - 1);
        }
        __syncthreads();
    }
    if (!CNT && owner && n >= 0)
        for (long long i = (long long)tmax * s + lane; i < (long long)ts * s; i += 32) g[i] = 0.f;
    if constexpr (CNT)
        if (cnt.tab_sm) mwd_cnt_flush(cnt, ctab);  // every add is in: the loop's last barrier
    if constexpr (BF16 && XT > 0) {
#pragma unroll
        for (int i = 0; i < 4 * XT; ++i) {
            const int u = warp + (MWD_NT / 32) * i;
            if (u >= mt_n * n8) break;
            const int k = (u / n8) * 16 + lg, jj = (u % n8) * 8 + 2 * lt;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int kq = k + 8 * (q / 2), jq = jj + q % 2;
                if (kq < s && jq < s) xp[kq * s + jq] = xr[i / 4][4 * (i % 4) + q];
            }
        }
    } else if constexpr (XT > 0) {
#pragma unroll
        for (int r = 0; r < XT; ++r) {
            const int u = threadIdx.x + r * MWD_NT;
            if (u >= ntiles) continue;
            const int ti = u / nt4, tj = u - ti * nt4;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const int k = 4 * ti + c / 4, jj = 4 * tj + c % 4;
                if (k < s && jj < s) xp[k * s + jj] = xr[r][c];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Launch planning, shared by K4's and K2's C entry points.
// ---------------------------------------------------------------------------

static int mwd_sp(int s) { return s <= 8 ? 8 : s <= 16 ? 16 : 32; }

// Utterances of a block-path block.
static int mwd_blk_b(int n, int s) { return s <= 64 && n >= MWD_B8_MIN_UTT ? 8 : MWD_B; }

static int mwd_n_blocks(int n, int s) {
    const int per = s <= 32 ? MWD_WARPS * (32 / mwd_sp(s)) : mwd_blk_b(n, s);
    return (n + per - 1) / per;
}

struct MwdPlan {
    int tc, tab_sm;
    size_t bytes;  // dynamic shared memory
    int glob;      // 1: the buffers in device memory, mwd_layout(...).total floats a block
    int cnt_sm;    // K2's backward: 1 when its count table is in shared memory
};

// The block path's buffers: the table in shared memory where it fits (the
// backward with xi's chunk of at least 4 steps beside it), else in device
// memory; the chunk as long as what is left allows, up to MWD_TC_MAX; and
// where not even one step of the buffers fits, all of them in device memory.
static MwdPlan mwd_plan(int s, bool bwd, bool remat, int b, bool bf16) {
    auto bytes = [&](int tc, bool tab_sm) {
        return (size_t)mwd_layout(s, tc, tab_sm, bwd, remat, b, bf16).total * sizeof(float);
    };
    for (int tab_sm = 1; tab_sm >= 0; --tab_sm)
        for (int tc = bwd ? MWD_TC_MAX : 0; tc >= (bwd ? (tab_sm ? 4 : 1) : 0); --tc)
            if (bytes(tc, tab_sm) <= MWD_SMEM_OPTIN_MAX)
                return {tc, tab_sm, bytes(tc, tab_sm), 0, 0};
    return {bwd ? MWD_TC_MAX : 0, 0, 0, 1, 0};
}

// K2's backward (S <= 64, the table T always in shared memory) with a count
// table of cnt 64-bit entries: in shared memory beside the buffers where
// both fit with two blocks an SM (the latency-bound sweep needs the second
// block's warps; xi's chunk shrinks first), else the counts in device
// memory (each posterior two 64-bit atomics there): at the VQ teacher's
// shape, 64 x 201 entries, that takes 2.75 ms a call against 4.05 with the
// table and one block an SM (NVIDIA H100 80GB HBM3, 700 W).
static MwdPlan mwd_plan_counts(int s, int b, bool bf16, int cnt) {
    auto bytes = [&](int tc, bool cnt_sm) {
        return (size_t)mwd_layout(s, tc, true, true, false, b, bf16, true, cnt_sm ? cnt : 0).total *
               sizeof(float);
    };
    const size_t two = MWD_SMEM_SM / 2 - 1024;
    for (int tc = MWD_TC_MAX; tc >= 2; --tc)
        if (bytes(tc, true) <= two) return {tc, 1, bytes(tc, true), 0, 1};
    for (int tc = MWD_TC_MAX; tc >= 1; --tc)
        if (bytes(tc, false) <= two) return {tc, 1, bytes(tc, false), 0, 0};
    return {1, 1, bytes(1, false), 0, 0};
}

// Floats of the per-block buffers in device memory: the most that the
// forward's or the backward's plan needs, in either dtype, times the blocks.
static long long mwd_glob_floats(int n, int s, int tcr) {
    if (s <= 32) return 0;
    const int b = mwd_blk_b(n, s);
    long long most = 0;
    for (int bf16 = 0; bf16 < 2; ++bf16)
        for (int bwd = 0; bwd < 2; ++bwd) {
            const bool remat = bwd && tcr > 0;
            const MwdPlan pl = mwd_plan(s, bwd, remat, b, bf16);
            const long long f = mwd_layout(s, pl.tc, false, bwd, remat, b, bf16).total;
            if (pl.glob && f > most) most = f;
        }
    return most * mwd_n_blocks(n, s);
}

// The workspace, in floats, each part a multiple of 4: the prepared tables
// (2 S^2 + 1, rounded up), the length order (N ints, and its partial ranks,
// N * mwd_order_slices(N) ints), the alphas (or K6's checkpoints),
// the blocks' xi partials and the reduction's slices, K6's recomputed
// chunks (block path), the blocks' buffers where they live in device memory.
struct MwdWork {
    long long ws, perm, part, alph, xpart, achunk, gbuf, total;
};

static MwdWork mwd_work(int n, int ts, int s, int tcr) {
    const long long nb = mwd_n_blocks(n, s), ss = (long long)s * s;
    MwdWork w;
    long long o = 0;
    w.ws = o;     o += (2 * ss + 4) & ~3LL;
    w.perm = o;   o += mwd_up4(n);
    w.part = o;   o += ((long long)n * mwd_order_slices(n) + 3) & ~3LL;
    w.alph = o;   o += (long long)n * (tcr ? (ts + tcr - 1) / tcr : ts) * s;
    o = (o + 3) & ~3LL;
    w.xpart = o;  o += (nb + MWD_XI_SLICES) * ss;
    o = (o + 3) & ~3LL;
    w.achunk = o; o += (s > 32 && tcr > 0) ? nb * tcr * mwd_blk_b(n, s) * s : 0;
    o = (o + 3) & ~3LL;
    w.gbuf = o;   o += mwd_glob_floats(n, s, tcr);
    w.total = o;
    return w;
}

template <typename Kernel, typename... Args>
static int mwd_go(Kernel kernel, int blocks, int threads, size_t smem, void* stream,
                  Args... args) {
    const int st = mwd_smem_optin(kernel, smem);
    if (st != 0) return st;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

// The length order (order.cuh) and the prepared table, by `prep` (K4's or
// K2's preparation kernel).
template <typename Prep>
static int mwd_estep_prepare(Prep prep, const float* base, const int* lens, float* work,
                             const MwdWork& w, int n, int s, int bf16, cudaStream_t st) {
    int* part = reinterpret_cast<int*>(work + w.part);
    mwd_length_rank<<<mwd_order_grid(n), MWD_ORDER_NT, 0, st>>>(lens, n, part);
    prep<<<mwd_order_grid(n).x, MWD_ORDER_NT, 0, st>>>(base, part, n, s, bf16, work + w.ws,
                                                       reinterpret_cast<int*>(work + w.perm));
    return (int)cudaGetLastError();
}

// xi = T * (the sum of the blocks' partials), by `reduce` (K4's or K2's
// reduction kernel): one pass over them, or two (MWD_XI_SLICES slices, then
// their sum) when there are many.
template <typename Reduce>
static int mwd_estep_xi(Reduce reduce, float* work, const MwdWork& w, int n, int s, float* xi,
                        cudaStream_t st) {
    const float* ws = work + w.ws;
    float* xpart = work + w.xpart;
    const int nb = mwd_n_blocks(n, s), ss = s * s, gx = (ss + 255) / 256;
    if (nb <= MWD_XI_SLICES) {
        reduce<<<dim3(gx, 1), 256, 0, st>>>(xpart, nb, ss, ws, xi);
    } else {
        float* sl = xpart + (long long)nb * ss;
        reduce<<<dim3(gx, MWD_XI_SLICES), 256, 0, st>>>(xpart, nb, ss, nullptr, sl);
        reduce<<<dim3(gx, 1), 256, 0, st>>>(sl, MWD_XI_SLICES, ss, ws, xi);
    }
    return (int)cudaGetLastError();
}
