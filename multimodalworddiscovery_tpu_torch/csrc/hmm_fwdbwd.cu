// K2: the fused discrete-HMM E-step over factored transitions.
//
// Forward, then a backward sweep that accumulates the pooled transition
// posteriors and the (phone, concept) expected counts, so the state
// posteriors gamma never reach device memory.  Replaces
// multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
// hmm_estep_counts_pallas (_fwd_kernel, then _bwd_counts_kernel with the
// step math of _bwd_math).  K4 and K6, the general E-step that writes gamma,
// are in hmm_estep.cu.
//
// Both kernels take BF16 as a template parameter: dot_dtype="bfloat16" of
// the TPU kernels, whose MXU products read bf16 operands and accumulate in
// fp32.  Here the operands of the three products (exp(base0) and e in the
// forward; exp(base0), f and ea in the backward) are rounded to bf16
// (round to nearest even) and widened back to fp32 before each FMA: a bf16
// x bf16 product is exact in fp32, so only the order of summation differs
// from the TPU kernel.  The forward only multiplies by exp(base0), so its
// table is rounded once as it is loaded.  The backward's xi update
// multiplies by the fp32 exp(base0), as the TPU kernel's bexp32 * xc does,
// so there one fp32 table in shared memory serves both and the product
// rounds it on read.  Tensor cores are not used.
//
// Transitions come factored, trans[n, s, s'] = base[s, s'] - rowz[n, s] +
// colmask[n, s'], and each step's log-semiring product is a plain product
// on max-rescaled exponentials: p[s'] = sum_s exp(base0[s, s']) *
// exp(a2[s] - m).
//
// What bounds it on the H100: the recursion is sequential in time and tiny
// per step (S <= 64 states, the discrete route's gate), so it is bound by
// latency (one barrier, one block reduction and an S-term FMA chain per
// step), not by FLOPs or bytes.  The design runs one block per utterance,
// one thread per state, so the card holds thousands of independent
// recursions in flight; exp(base0) sits in shared memory with a padded row
// stride (s + 1), which keeps both the forward's column walk and the
// backward's row walk free of bank conflicts.  The TPU kernels' lane-major
// layout, VMEM tiling and deferred per-state histograms are not carried
// over: the counts go straight to device memory with one atomicAdd per
// nonzero posterior, and the per-block xi table goes out with one atomicAdd
// per entry at the end.  Atomics make the summation order vary between
// runs, so comparisons use tolerances, never bitwise equality.

#include "common.cuh"

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
// e_sh [S] and red [32] are shared scratch; two barriers.  The table
// already holds exp(base0) as the product reads it (rounded to bf16 with
// BF16).
template <bool BF16>
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
            p = fmaf(bexp[k * sp + j], e_sh[k], p);
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
// One block per utterance, thread j = state j.
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
        alpha = mwd_fwd_step<BF16>(bexp, e_sh, red, alpha, rz, cm, em_t, t < len, act, s);
        if (act) al[(long long)t * s + j] = alpha;
    }
    mwd_store_logz(alpha, act, len, red, logz + n);
}

// Backward sweep.  Walks t down from Ts - 1 carrying eb = emit[t + 1] +
// beta[t + 1], accumulates the pooled xi, and adds each step's posterior
// gamma into the (phone, concept) counts.
template <bool BF16>
__global__ void mwd_hmm_bwd_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const float* __restrict__ alphas,   // [N, Ts, S]
    const float* __restrict__ logz,     // [N]
    const int* __restrict__ lens,       // [N]
    const int* __restrict__ src,        // [N, Ts] phone ids
    const int* __restrict__ conc,       // [N, S] concept id of each state
    float* __restrict__ counts,         // [F, E], accumulated into
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
    const int cj = act ? conc[row + j] : 0;
    float eb = MWD_NEG_INF;
    __syncthreads();
    for (int t = ts - 1; t >= 0; --t) {
        const float a_t = act ? al[(long long)t * s + j] : 0.f;
        const float em_t = act ? em[(long long)t * s + j] : 0.f;
        const float g = mwd_bwd_step<BF16>(bexp, xi_acc, f_sh, ea_sh, red, eb, a_t, em_t, rz,
                                           cm, lzs, t, len, act, s);
        if (act && g != 0.f) {
            const int ph = src[(long long)n * ts + t];
            // ids are validated when the corpus is built; an id outside
            // the table already made K1's emission NaN
            if (ph >= 0 && ph < f && cj >= 0 && cj < e)
                atomicAdd(&counts[(long long)ph * e + cj], g);
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

// K2's forward (alphas out); bf16 != 0 selects the bf16 variant.
extern "C" int mwd_hmm_fwd(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           float* alphas, float* logz, int n, int ts, int s, int bf16,
                           void* stream) {
    if (mwd_bad_shape(n, ts, s, MWD_MAX_S)) return (int)cudaErrorInvalidValue;
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
        return mwd_launch(mwd_hmm_bwd_kernel<true>, smem, n, s, stream, base, rowz, colmask,
                          emit, alphas, logz, lens, src, conc, counts, xi, ts, s, f, e);
    return mwd_launch(mwd_hmm_bwd_kernel<false>, smem, n, s, stream, base, rowz, colmask, emit,
                      alphas, logz, lens, src, conc, counts, xi, ts, s, f, e);
}
