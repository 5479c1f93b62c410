// K2, K4 and K6: the HMM E-step over factored transitions.
//
// K2, the fused discrete-HMM E-step: forward, then a backward sweep that
// accumulates the pooled transition posteriors and the (phone, concept)
// expected counts, so the state posteriors gamma never reach device memory.
// Replaces multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
// hmm_estep_counts_pallas (_fwd_kernel, then _bwd_counts_kernel with the
// step math of _bwd_math).
//
// K4, the general E-step every Vogel-HMM aligner runs (Gaussian, DNN and
// CRF emissions, and the discrete HMM outside K2's gate): the same forward,
// then a backward sweep that writes gamma [N, Ts, S] and the pooled xi.
// Replaces hmm_fwdbwd_pallas.py: hmm_estep_pallas (_fwd_kernel, then
// _bwd_kernel with the same _bwd_math).
//
// K6, K4's rematerialized variant (hmm_estep_pallas(remat=True):
// _fwd_ckpt_kernel, then _bwd_remat_kernel): the forward writes only the
// alpha entering each time chunk, and the backward walks the chunks in
// reverse, recomputing each chunk's alphas from its checkpoint before the
// beta / gamma / xi sweep.  In the one-block-per-utterance,
// one-thread-per-state layout below, thread j only ever reads alpha[t][j],
// so each thread keeps its own state's chunk of alphas in a local array
// (MWD_REMAT_MAX_TC entries): shared memory stays what K4's backward uses,
// and K6 keeps K4's limit S <= 160.  The forward and backward steps are
// the same __device__ functions in K4 and K6, so the recomputed alphas are
// the forward's, bit for bit, when the compiler emits the same code for
// both inlined copies.
//
// Every kernel takes BF16 as a template parameter: dot_dtype="bfloat16" of
// the TPU kernels, whose MXU products read bf16 operands and accumulate in
// fp32.  Here the operands of the three products (exp(base0) and e in the
// forward; exp(base0), f and ea in the backward) are rounded to bf16
// (round to nearest even) and widened back to fp32 before each FMA: a bf16
// x bf16 product is exact in fp32, so only the order of summation differs
// from the TPU kernel.  The forward kernels only multiply by exp(base0), so
// their table is rounded once as it is loaded.  The backward's xi update
// multiplies by the fp32 exp(base0), as the TPU kernel's bexp32 * xc does,
// so there one fp32 table in shared memory serves both and the product
// rounds it on read (K4's backward has no room for a second table at S =
// 160).  Tensor cores are not used.
//
// Transitions come factored, trans[n, s, s'] = base[s, s'] - rowz[n, s] +
// colmask[n, s'], and each step's log-semiring product is a plain product
// on max-rescaled exponentials: p[s'] = sum_s exp(base0[s, s']) *
// exp(a2[s] - m).
//
// What bounds it on the H100: the recursion is sequential in time and tiny
// per step (S <= 160 states), so it is bound by latency (one barrier, one
// block reduction and an S-term FMA chain per step), not by FLOPs or bytes;
// K4 also streams gamma out, N*Ts*S floats, in coalesced rows.  The design
// runs one block per utterance, one thread per state, so the card holds
// thousands of independent recursions in flight; exp(base0) sits in shared
// memory with a padded row stride (s + 1), which keeps both the forward's
// column walk and the backward's row walk free of bank conflicts; shared
// memory is sized by S at launch, so small-S blocks pack many to an SM, and
// above 48 KB (S > 109 in the forward, S > 77 in the backward) the kernel
// opts into the larger limit.  The TPU kernels' lane-major layout, VMEM
// tiling and deferred per-state histograms are not carried over: K2's
// counts go straight to device memory with one atomicAdd per nonzero
// posterior, and the per-block xi table goes out with one atomicAdd per
// entry at the end.  Atomics make the summation order vary between runs,
// so comparisons use tolerances, never bitwise equality.

#include <cuda_bf16.h>

#include "common.cuh"

// Longest time chunk K6 takes: each thread's local array of its state's
// in-chunk alphas.
#define MWD_REMAT_MAX_TC 64

// An operand of a product as the TPU kernel's MXU reads it: unchanged in
// fp32, rounded to bf16 (nearest even) and widened back with BF16.
template <bool BF16>
__device__ __forceinline__ float mwd_dot_in(float x) {
    if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
    return x;
}

// exp(base0) into shared memory, base0 = max(base - max(base), NEG_INF),
// row stride s + 1, rounded to bf16 with ROUND.  Returns max(base).  The
// caller syncs before use.
template <bool ROUND>
__device__ __forceinline__ float mwd_load_bexp(const float* __restrict__ base, int s,
                                               float* bexp, float* red) {
    float mb = -INFINITY;
    for (int i = threadIdx.x; i < s * s; i += blockDim.x) mb = fmaxf(mb, base[i]);
    mb = mwd_block_max(mb, red);
    for (int i = threadIdx.x; i < s * s; i += blockDim.x)
        bexp[(i / s) * (s + 1) + (i % s)] =
            mwd_dot_in<ROUND>(expf(fmaxf(base[i] - mb, MWD_NEG_INF)));
    return mb;
}

// One forward step for thread j = state j: alpha'[j] = log(sum_k
// exp(base0[k, j]) e[k]) + m + emit[t, j] + colmask[j], e = exp(alpha -
// rowz0 - m).  Past the utterance's length (!alive) alpha is carried.
// e_sh [S] and red [32] are shared scratch; two barriers.  TABLE_BF16: the
// table already holds exp(base0) rounded to bf16 (the forward kernels'); K6's
// backward passes its fp32 table, rounded here on read.
template <bool BF16, bool TABLE_BF16>
__device__ __forceinline__ float mwd_fwd_step(const float* bexp, float* e_sh, float* red,
                                              float alpha, float rz, float cm, float em_t,
                                              bool alive, bool act, int s) {
    const int j = threadIdx.x;
    const int sp = s + 1;
    const float a2 = act ? alpha - rz : -INFINITY;
    const float m = mwd_block_max(a2, red);
    const float ms = m > MWD_NEG_INF / 2 ? m : 0.f;
    if (act) e_sh[j] = mwd_dot_in<BF16>(expf(a2 - ms));
    __syncthreads();
    if (act) {
        float p = 0.f;
        for (int k = 0; k < s; ++k)
            p = fmaf(mwd_dot_in<BF16 && !TABLE_BF16>(bexp[k * sp + j]), e_sh[k], p);
        float upd = p > 0.f ? logf(fmaxf(p, 1e-38f)) + ms : MWD_NEG_INF;
        upd = upd + em_t + cm;
        if (alive) alpha = upd;
    }
    __syncthreads();
    return alpha;
}

// logZ of one utterance from its last alpha (0 for an empty utterance).
__device__ __forceinline__ void mwd_store_logz(float alpha, bool act, int len, float* red,
                                               float* logz_n) {
    const float m = mwd_block_max(act ? alpha : -INFINITY, red);
    const float ms = m > MWD_NEG_INF / 2 ? m : 0.f;
    const float z = mwd_block_sum(act ? expf(alpha - ms) : 0.f, red);
    if (threadIdx.x == 0) {
        const float lz = m > MWD_NEG_INF / 2 ? logf(z + 1e-38f) + ms : MWD_NEG_INF;
        *logz_n = len > 0 ? lz : 0.f;  // empty utterance: log Z = 0
    }
}

// One backward step at time t for thread j = state j.  Takes the carry
// eb = emit[t + 1] + beta[t + 1] and alpha[t][j]; returns gamma[t][j],
// leaves emit[t] + beta[t] in eb, and for t + 1 < len adds exp(base0[k, j])
// ea[k] f[j] into column j of xi_acc.  f_sh, ea_sh [S] and red [32] are
// shared scratch; two barriers.
template <bool BF16>
__device__ __forceinline__ float mwd_bwd_step(const float* bexp, float* xi_acc, float* f_sh,
                                              float* ea_sh, float* red, float& eb, float a_t,
                                              float em_t, float rz, float cm, float lzs, int t,
                                              int len, bool act, int s) {
    const int j = threadIdx.x;
    const int sp = s + 1;
    const float ebm = act ? eb + cm : -INFINITY;
    const float m2 = mwd_block_max(ebm, red);
    const float m2s = m2 > MWD_NEG_INF / 2 ? m2 : 0.f;
    const float fv = act ? mwd_dot_in<BF16>(expf(ebm - m2s)) : 0.f;
    // ea = exp(alpha - rowz0 - logZ + m2), clamped for fp32 safety
    const float ea = (act && t + 1 < len)
                         ? mwd_dot_in<BF16>(expf(fminf(a_t - rz - lzs + m2s, 80.f)))
                         : 0.f;
    if (act) {
        f_sh[j] = fv;
        ea_sh[j] = ea;
    }
    __syncthreads();
    float g = 0.f;
    if (act) {
        float q = 0.f;  // q[j] = sum_s' exp(base0[j, s']) f[s']
        for (int k = 0; k < s; ++k) q = fmaf(mwd_dot_in<BF16>(bexp[j * sp + k]), f_sh[k], q);
        float upd = q > 0.f ? logf(fmaxf(q, 1e-38f)) + m2s : MWD_NEG_INF;
        upd = upd - rz;
        const float beta = (t + 1 >= len) ? 0.f : upd;
        g = t < len ? expf(fminf(a_t + beta - lzs, 0.f)) : 0.f;
        // xi[k, j] += exp(base0[k, j]) ea[k] f[j] (fp32 exp(base0)): thread
        // j owns column j
        if (t + 1 < len)
            for (int k = 0; k < s; ++k) xi_acc[k * s + j] += bexp[k * sp + j] * (ea_sh[k] * fv);
        eb = em_t + beta;
    }
    __syncthreads();
    return g;
}

// The per-block xi table into the pooled [S, S] output.
__device__ __forceinline__ void mwd_flush_xi(const float* xi_acc, float* xi, int s) {
    for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
        const float v = xi_acc[i];
        if (v != 0.f) atomicAdd(&xi[i], v);
    }
}

// Forward: alpha[t] for every t (frozen past src_len) and logZ.
// One block per utterance, thread j = state j.  Shared by K2 and K4.
template <bool BF16>
__global__ void mwd_hmm_fwd_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ init,     // [N, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const int* __restrict__ lens,       // [N]
    float* __restrict__ alphas,         // out [N, Ts, S]
    float* __restrict__ logz,           // out [N]
    int ts, int s) {
    extern __shared__ float smem[];
    float* bexp = smem;                    // [S, S + 1]
    float* e_sh = bexp + s * (s + 1);      // [S]
    float* red = e_sh + s;                 // [32]
    const int n = blockIdx.x;
    const int j = threadIdx.x;
    const bool act = j < s;
    const float mb = mwd_load_bexp<BF16>(base, s, bexp, red);
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    float* al = alphas + row * ts;
    const int len = lens[n];
    const float rz = act ? rowz[row + j] - mb : 0.f;  // rowz0
    const float cm = act ? colmask[row + j] : 0.f;
    float alpha = act ? init[row + j] + em[j] : -INFINITY;
    if (act) al[j] = alpha;
    __syncthreads();
    for (int t = 1; t < ts; ++t) {
        const float em_t = act ? em[(long long)t * s + j] : 0.f;
        alpha = mwd_fwd_step<BF16, BF16>(bexp, e_sh, red, alpha, rz, cm, em_t, t < len, act, s);
        if (act) al[(long long)t * s + j] = alpha;
    }
    mwd_store_logz(alpha, act, len, red, logz + n);
}

// Backward sweep.  Walks t down from Ts - 1 carrying eb = emit[t + 1] +
// beta[t + 1], accumulates the pooled xi, and hands each step's posterior
// gamma to its consumer: K2 adds it into the (phone, concept) counts, K4
// writes it out.  COUNTS selects the consumer at compile time.
template <bool COUNTS, bool BF16>
__global__ void mwd_hmm_bwd_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const float* __restrict__ alphas,   // [N, Ts, S]
    const float* __restrict__ logz,     // [N]
    const int* __restrict__ lens,       // [N]
    const int* __restrict__ src,        // K2: [N, Ts] phone ids
    const int* __restrict__ conc,       // K2: [N, S] concept id of each state
    float* __restrict__ counts,         // K2: [F, E], accumulated into
    float* __restrict__ gamma,          // K4: out [N, Ts, S]
    float* __restrict__ xi,             // [S, S], accumulated into
    int ts, int s, int f, int e) {
    extern __shared__ float smem[];
    float* bexp = smem;                    // [S, S + 1]
    float* xi_acc = bexp + s * (s + 1);    // [S, S]
    float* f_sh = xi_acc + s * s;          // [S]
    float* ea_sh = f_sh + s;               // [S]
    float* red = ea_sh + s;                // [32]
    const int n = blockIdx.x;
    const int j = threadIdx.x;
    const bool act = j < s;
    const float mb = mwd_load_bexp<false>(base, s, bexp, red);
    for (int i = j; i < s * s; i += blockDim.x) xi_acc[i] = 0.f;
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    const float* al = alphas + row * ts;
    const int len = lens[n];
    const float lzn = logz[n];
    const float lzs = lzn > MWD_NEG_INF / 2 ? lzn : 0.f;
    const float rz = act ? rowz[row + j] - mb : 0.f;  // rowz0
    const float cm = act ? colmask[row + j] : 0.f;
    const int cj = (COUNTS && act) ? conc[row + j] : 0;
    float eb = MWD_NEG_INF;
    __syncthreads();
    for (int t = ts - 1; t >= 0; --t) {
        const float a_t = act ? al[(long long)t * s + j] : 0.f;
        const float em_t = act ? em[(long long)t * s + j] : 0.f;
        const float g = mwd_bwd_step<BF16>(bexp, xi_acc, f_sh, ea_sh, red, eb, a_t, em_t, rz,
                                           cm, lzs, t, len, act, s);
        if (!act) continue;
        if (COUNTS) {
            if (g != 0.f) {
                const int ph = src[(long long)n * ts + t];
                // ids are validated when the corpus is built; an id
                // outside the table already made K1's emission NaN
                if (ph >= 0 && ph < f && cj >= 0 && cj < e)
                    atomicAdd(&counts[(long long)ph * e + cj], g);
            }
        } else {
            gamma[row * ts + (long long)t * s + j] = g;
        }
    }
    mwd_flush_xi(xi_acc, xi, s);
}

// K6 forward: like the forward above, but writes only ckpt[n, c] = the
// alpha entering time chunk c (alpha[c * tc - 1]; chunk 0's slot holds
// alpha[0], which the backward does not read) and logZ.
template <bool BF16>
__global__ void mwd_hmm_fwd_ckpt_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ init,     // [N, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const int* __restrict__ lens,       // [N]
    float* __restrict__ ckpt,           // out [N, n_chunks, S]
    float* __restrict__ logz,           // out [N]
    int ts, int s, int tc) {
    extern __shared__ float smem[];
    float* bexp = smem;                    // [S, S + 1]
    float* e_sh = bexp + s * (s + 1);      // [S]
    float* red = e_sh + s;                 // [32]
    const int n = blockIdx.x;
    const int j = threadIdx.x;
    const bool act = j < s;
    const int n_chunks = (ts + tc - 1) / tc;
    const float mb = mwd_load_bexp<BF16>(base, s, bexp, red);
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    float* ck = ckpt + (long long)n * n_chunks * s;
    const int len = lens[n];
    const float rz = act ? rowz[row + j] - mb : 0.f;  // rowz0
    const float cm = act ? colmask[row + j] : 0.f;
    float alpha = act ? init[row + j] + em[j] : -INFINITY;
    if (act) {
        ck[j] = alpha;
        if (tc == 1 && ts > 1) ck[s + j] = alpha;
    }
    __syncthreads();
    for (int t = 1; t < ts; ++t) {
        const float em_t = act ? em[(long long)t * s + j] : 0.f;
        alpha = mwd_fwd_step<BF16, BF16>(bexp, e_sh, red, alpha, rz, cm, em_t, t < len, act, s);
        if (act && (t + 1) % tc == 0 && t + 1 < ts) ck[(long long)((t + 1) / tc) * s + j] = alpha;
    }
    mwd_store_logz(alpha, act, len, red, logz + n);
}

// K6 backward: chunks in reverse; each chunk's alphas are recomputed from
// its checkpoint (t == 0 restarts from init + emit[0]) into the thread's
// local array, then K4's backward step runs over the chunk.
template <bool BF16>
__global__ void mwd_hmm_bwd_remat_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ init,     // [N, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const float* __restrict__ ckpt,     // [N, n_chunks, S]
    const float* __restrict__ logz,     // [N]
    const int* __restrict__ lens,       // [N]
    float* __restrict__ gamma,          // out [N, Ts, S]
    float* __restrict__ xi,             // [S, S], accumulated into
    int ts, int s, int tc) {
    extern __shared__ float smem[];
    float* bexp = smem;                    // [S, S + 1]
    float* xi_acc = bexp + s * (s + 1);    // [S, S]
    float* f_sh = xi_acc + s * s;          // [S]; also the forward step's e
    float* ea_sh = f_sh + s;               // [S]
    float* red = ea_sh + s;                // [32]
    float al_loc[MWD_REMAT_MAX_TC];        // alpha[c0 + i][j]
    const int n = blockIdx.x;
    const int j = threadIdx.x;
    const bool act = j < s;
    const int n_chunks = (ts + tc - 1) / tc;
    const float mb = mwd_load_bexp<false>(base, s, bexp, red);
    for (int i = j; i < s * s; i += blockDim.x) xi_acc[i] = 0.f;
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    const float* ck = ckpt + (long long)n * n_chunks * s;
    const int len = lens[n];
    const float lzn = logz[n];
    const float lzs = lzn > MWD_NEG_INF / 2 ? lzn : 0.f;
    const float rz = act ? rowz[row + j] - mb : 0.f;  // rowz0
    const float cm = act ? colmask[row + j] : 0.f;
    float eb = MWD_NEG_INF;
    __syncthreads();
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int c0 = c * tc;
        const int cl = min(tc, ts - c0);
        float alpha = act ? ck[(long long)c * s + j] : -INFINITY;
        for (int i = 0; i < cl; ++i) {
            const int t = c0 + i;
            if (t == 0) {
                alpha = act ? init[row + j] + em[j] : -INFINITY;
            } else {
                const float em_t = act ? em[(long long)t * s + j] : 0.f;
                alpha = mwd_fwd_step<BF16, false>(bexp, f_sh, red, alpha, rz, cm, em_t, t < len,
                                                     act, s);
            }
            al_loc[i] = alpha;
        }
        for (int i = cl - 1; i >= 0; --i) {
            const int t = c0 + i;
            const float em_t = act ? em[(long long)t * s + j] : 0.f;
            const float g = mwd_bwd_step<BF16>(bexp, xi_acc, f_sh, ea_sh, red, eb, al_loc[i],
                                               em_t, rz, cm, lzs, t, len, act, s);
            if (act) gamma[row * ts + (long long)t * s + j] = g;
        }
    }
    mwd_flush_xi(xi_acc, xi, s);
}

static size_t mwd_fwd_smem(int s) { return (size_t)(s * (s + 1) + s + 32) * sizeof(float); }
static size_t mwd_bwd_smem(int s) {
    return (size_t)(s * (s + 1) + s * s + 2 * s + 32) * sizeof(float);
}

// Opt a kernel into its shared memory and launch it: one block per
// utterance, one thread per state (rounded up to a warp).
template <typename Kernel, typename... Args>
static int mwd_launch(Kernel kernel, size_t smem, int n, int s, void* stream, Args... args) {
    const int st = mwd_smem_optin(kernel, smem);
    if (st != 0) return st;
    kernel<<<n, mwd_state_threads(s), smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

static bool mwd_bad_shape(int n, int ts, int s, int max_s) {
    return s < 1 || s > max_s || ts < 1 || n < 0;
}

// Forward of K2 and K4 (alphas out); bf16 != 0 selects the bf16 variant.
extern "C" int mwd_hmm_fwd(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           float* alphas, float* logz, int n, int ts, int s, int bf16,
                           void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S_GENERAL)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_fwd_smem(s);
    if (bf16)
        return mwd_launch(mwd_hmm_fwd_kernel<true>, smem, n, s, stream, base, init, rowz,
                          colmask, emit, lens, alphas, logz, ts, s);
    return mwd_launch(mwd_hmm_fwd_kernel<false>, smem, n, s, stream, base, init, rowz,
                      colmask, emit, lens, alphas, logz, ts, s);
}

// K2's backward (fused counts), S <= 64 as the discrete route's gate.
extern "C" int mwd_hmm_bwd_counts(const float* base, const float* rowz,
                                  const float* colmask, const float* emit,
                                  const float* alphas, const float* logz, const int* src,
                                  const int* conc, const int* lens, float* counts,
                                  float* xi, int n, int ts, int s, int f, int e, int bf16,
                                  void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_bwd_smem(s);
    if (bf16)
        return mwd_launch(mwd_hmm_bwd_kernel<true, true>, smem, n, s, stream, base, rowz,
                          colmask, emit, alphas, logz, lens, src, conc, counts,
                          (float*)nullptr, xi, ts, s, f, e);
    return mwd_launch(mwd_hmm_bwd_kernel<true, false>, smem, n, s, stream, base, rowz, colmask,
                      emit, alphas, logz, lens, src, conc, counts, (float*)nullptr, xi, ts, s,
                      f, e);
}

// K4's backward (gamma out), S <= MWD_MAX_S_GENERAL.
extern "C" int mwd_hmm_bwd_gamma(const float* base, const float* rowz,
                                 const float* colmask, const float* emit,
                                 const float* alphas, const float* logz, const int* lens,
                                 float* gamma, float* xi, int n, int ts, int s, int bf16,
                                 void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S_GENERAL)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_bwd_smem(s);
    const int* no_ids = nullptr;
    float* no_counts = nullptr;
    if (bf16)
        return mwd_launch(mwd_hmm_bwd_kernel<false, true>, smem, n, s, stream, base, rowz,
                          colmask, emit, alphas, logz, lens, no_ids, no_ids, no_counts, gamma,
                          xi, ts, s, 0, 0);
    return mwd_launch(mwd_hmm_bwd_kernel<false, false>, smem, n, s, stream, base, rowz, colmask,
                      emit, alphas, logz, lens, no_ids, no_ids, no_counts, gamma, xi, ts, s, 0,
                      0);
}

// K6's forward (chunk checkpoints out), 1 <= tc <= MWD_REMAT_MAX_TC.
extern "C" int mwd_hmm_fwd_ckpt(const float* base, const float* init, const float* rowz,
                                const float* colmask, const float* emit, const int* lens,
                                float* ckpt, float* logz, int n, int ts, int s, int tc,
                                int bf16, void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S_GENERAL) || tc < 1 || tc > MWD_REMAT_MAX_TC)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_fwd_smem(s);
    if (bf16)
        return mwd_launch(mwd_hmm_fwd_ckpt_kernel<true>, smem, n, s, stream, base, init, rowz,
                          colmask, emit, lens, ckpt, logz, ts, s, tc);
    return mwd_launch(mwd_hmm_fwd_ckpt_kernel<false>, smem, n, s, stream, base, init, rowz,
                      colmask, emit, lens, ckpt, logz, ts, s, tc);
}

// K6's backward (alphas recomputed per chunk, gamma out).
extern "C" int mwd_hmm_bwd_remat(const float* base, const float* init, const float* rowz,
                                 const float* colmask, const float* emit, const float* ckpt,
                                 const float* logz, const int* lens, float* gamma, float* xi,
                                 int n, int ts, int s, int tc, int bf16, void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S_GENERAL) || tc < 1 || tc > MWD_REMAT_MAX_TC)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_bwd_smem(s);
    if (bf16)
        return mwd_launch(mwd_hmm_bwd_remat_kernel<true>, smem, n, s, stream, base, init, rowz,
                          colmask, emit, ckpt, logz, lens, gamma, xi, ts, s, tc);
    return mwd_launch(mwd_hmm_bwd_remat_kernel<false>, smem, n, s, stream, base, init, rowz,
                      colmask, emit, ckpt, logz, lens, gamma, xi, ts, s, tc);
}
