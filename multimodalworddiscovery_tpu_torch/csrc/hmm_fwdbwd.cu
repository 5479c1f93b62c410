// K2 and K4: the HMM E-step over factored transitions.
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

#include "common.cuh"

// exp(base0) into shared memory, base0 = max(base - max(base), NEG_INF),
// row stride s + 1.  Returns max(base).  The caller syncs before use.
__device__ __forceinline__ float mwd_load_bexp(const float* __restrict__ base, int s,
                                               float* bexp, float* red) {
    float mb = -INFINITY;
    for (int i = threadIdx.x; i < s * s; i += blockDim.x) mb = fmaxf(mb, base[i]);
    mb = mwd_block_max(mb, red);
    for (int i = threadIdx.x; i < s * s; i += blockDim.x)
        bexp[(i / s) * (s + 1) + (i % s)] = expf(fmaxf(base[i] - mb, MWD_NEG_INF));
    return mb;
}

// Forward: alpha[t] for every t (frozen past src_len) and logZ.
// One block per utterance, thread j = state j.  Shared by K2 and K4.
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
    const int sp = s + 1;
    const float mb = mwd_load_bexp(base, s, bexp, red);
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
        const float a2 = act ? alpha - rz : -INFINITY;
        const float m = mwd_block_max(a2, red);
        const float ms = m > MWD_NEG_INF / 2 ? m : 0.f;
        if (act) e_sh[j] = expf(a2 - ms);
        __syncthreads();
        if (act) {
            float p = 0.f;
            for (int k = 0; k < s; ++k) p = fmaf(bexp[k * sp + j], e_sh[k], p);
            float upd = p > 0.f ? logf(fmaxf(p, 1e-38f)) + ms : MWD_NEG_INF;
            upd = upd + em[(long long)t * s + j] + cm;
            if (t < len) alpha = upd;
            al[(long long)t * s + j] = alpha;
        }
        __syncthreads();
    }
    const float m = mwd_block_max(act ? alpha : -INFINITY, red);
    const float ms = m > MWD_NEG_INF / 2 ? m : 0.f;
    const float z = mwd_block_sum(act ? expf(alpha - ms) : 0.f, red);
    if (j == 0) {
        const float lz = m > MWD_NEG_INF / 2 ? logf(z + 1e-38f) + ms : MWD_NEG_INF;
        logz[n] = len > 0 ? lz : 0.f;  // empty utterance: log Z = 0
    }
}

// Backward sweep.  Walks t down from Ts - 1 carrying eb = emit[t + 1] +
// beta[t + 1], accumulates the pooled xi, and hands each step's posterior
// gamma to its consumer: K2 adds it into the (phone, concept) counts, K4
// writes it out.  COUNTS selects the consumer at compile time.
template <bool COUNTS>
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
    const int sp = s + 1;
    const float mb = mwd_load_bexp(base, s, bexp, red);
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
        const float ebm = act ? eb + cm : -INFINITY;
        const float m2 = mwd_block_max(ebm, red);
        const float m2s = m2 > MWD_NEG_INF / 2 ? m2 : 0.f;
        const float fv = act ? expf(ebm - m2s) : 0.f;
        const float a_t = act ? al[(long long)t * s + j] : 0.f;
        // ea = exp(alpha - rowz0 - logZ + m2), clamped for fp32 safety
        const float ea =
            (act && t + 1 < len) ? expf(fminf(a_t - rz - lzs + m2s, 80.f)) : 0.f;
        if (act) {
            f_sh[j] = fv;
            ea_sh[j] = ea;
        }
        __syncthreads();
        if (act) {
            float q = 0.f;  // q[j] = sum_s' exp(base0[j, s']) f[s']
            for (int k = 0; k < s; ++k) q = fmaf(bexp[j * sp + k], f_sh[k], q);
            float upd = q > 0.f ? logf(fmaxf(q, 1e-38f)) + m2s : MWD_NEG_INF;
            upd = upd - rz;
            const float beta = (t + 1 >= len) ? 0.f : upd;
            const float g = t < len ? expf(fminf(a_t + beta - lzs, 0.f)) : 0.f;
            // xi[k, j] += exp(base0[k, j]) ea[k] f[j]: thread j owns column j
            if (t + 1 < len)
                for (int k = 0; k < s; ++k)
                    xi_acc[k * s + j] += bexp[k * sp + j] * (ea_sh[k] * fv);
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
            eb = em[(long long)t * s + j] + beta;
        }
        __syncthreads();
    }
    for (int i = j; i < s * s; i += blockDim.x) {
        const float v = xi_acc[i];
        if (v != 0.f) atomicAdd(&xi[i], v);
    }
}

static size_t mwd_fwd_smem(int s) { return (size_t)(s * (s + 1) + s + 32) * sizeof(float); }
static size_t mwd_bwd_smem(int s) {
    return (size_t)(s * (s + 1) + s * s + 2 * s + 32) * sizeof(float);
}

extern "C" int mwd_hmm_fwd(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           float* alphas, float* logz, int n, int ts, int s,
                           void* stream) {
    if (s < 1 || s > MWD_MAX_S_GENERAL || ts < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_fwd_smem(s);
    const int st = mwd_smem_optin(mwd_hmm_fwd_kernel, smem);
    if (st != 0) return st;
    mwd_hmm_fwd_kernel<<<n, mwd_state_threads(s), smem, (cudaStream_t)stream>>>(
        base, init, rowz, colmask, emit, lens, alphas, logz, ts, s);
    return (int)cudaGetLastError();
}

// K2's backward (fused counts), S <= 64 as the discrete route's gate.
extern "C" int mwd_hmm_bwd_counts(const float* base, const float* rowz,
                                  const float* colmask, const float* emit,
                                  const float* alphas, const float* logz, const int* src,
                                  const int* conc, const int* lens, float* counts,
                                  float* xi, int n, int ts, int s, int f, int e,
                                  void* stream) {
    if (s < 1 || s > MWD_MAX_S || ts < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_bwd_smem(s);
    const int st = mwd_smem_optin(mwd_hmm_bwd_kernel<true>, smem);
    if (st != 0) return st;
    mwd_hmm_bwd_kernel<true><<<n, mwd_state_threads(s), smem, (cudaStream_t)stream>>>(
        base, rowz, colmask, emit, alphas, logz, lens, src, conc, counts, nullptr, xi,
        ts, s, f, e);
    return (int)cudaGetLastError();
}

// K4's backward (gamma out), S <= MWD_MAX_S_GENERAL.
extern "C" int mwd_hmm_bwd_gamma(const float* base, const float* rowz,
                                 const float* colmask, const float* emit,
                                 const float* alphas, const float* logz, const int* lens,
                                 float* gamma, float* xi, int n, int ts, int s,
                                 void* stream) {
    if (s < 1 || s > MWD_MAX_S_GENERAL || ts < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_bwd_smem(s);
    const int st = mwd_smem_optin(mwd_hmm_bwd_kernel<false>, smem);
    if (st != 0) return st;
    mwd_hmm_bwd_kernel<false><<<n, mwd_state_threads(s), smem, (cudaStream_t)stream>>>(
        base, rowz, colmask, emit, alphas, logz, lens, nullptr, nullptr, nullptr, gamma, xi,
        ts, s, 0, 0);
    return (int)cudaGetLastError();
}
