// K8: batched log-semiring matrix product,
// out[z, i, j] = logsumexp_k a[z, i, k] + b[z, k, j].
//
// Replaces multimodalworddiscovery_tpu/ops/log_semiring.py: log_matmul_pallas
// (_kernel), which is rank-2 (its callers vmap it) and streams K tiles in
// factored form: exp(A - m_a) @ exp(B - m_b) on the MXU with per-tile row
// maxima m_a and column maxima m_b, combined across tiles with a running
// maximum.  Here the batch comes as two strided dimensions (z = z1 * nb2 +
// z2) over row-major matrices, so the strided even / odd slices of an
// associative scan over time reach the kernel as views, without copies.
// Positions outside [I, K, J] read NEG_INF, the identity of logsumexp.
//
// Float32: the factored form with an underflow guard.  A term exp(a - M_i)
// exp(b - N_j) is a product of two exps, so the exps cost (I + J) K a
// product instead of the I J K of a term-by-term sum, and the sum is a plain
// fp32 product P @ Q on the FMA units (no TF32).  M_i is row i's maximum over
// all of K and N_j column j's (taken in the block where K fits in one tile,
// else by a preparation kernel), so out = M_i + N_j + log(acc).  In float32
// that form underflows: a term more than ~87 nats below M_i + N_j becomes 0
// (or denormal), even where it is the largest a[i, k] + b[k, j] of its
// (i, j).  Every lost term is below 2^-126 and every rounding step of the sum
// loses less, so where acc >= the guard threshold K 2^-101 (passed in by
// the wrapper, ops/log_semiring.guard_threshold) what was lost lies below
// 2^-24 of acc, fp32's rounding.  An element below it, with both maxima
// live, is summed again term by term from device memory with one exp a term
// relative to its running maximum (the old exact kernel's loop), over the
// k where both its row and its column are live (each row's and column's
// first and last live k are kept beside the maxima, so a product of banded
// matrices skips the elements outside the band at once).  The result is
// what the broadcast oracle (core/logsemiring.log_matmul) gives on every
// input, including rows that span hundreds of nats.  The elements that take
// the guard are counted on the card, and apart those with a live k in
// common (a zero-support element of a banded product takes the guard, and
// leaves at once).
//
// The float32 product: a 256-thread block computes a BM x BN output tile,
// each thread TM x TN outputs (rows ty + 16 r, columns 4 tx + 64 c + u), so a
// warp's float4 loads of P broadcast and those of Q are contiguous; P is kept
// [BM][TK + 4] (k contiguous, read 4 k at a time) and Q [TK][BN + 4].  Size
// classes (template parameters): 128 x 64 (8 x 4 a thread) where I > 64 and
// the batch gives two blocks an SM, else 64 x 64 (4 x 4; path 9's S = 64
// matrix is one block).  Where K <= MWD_LM_TK the whole K is one tile in
// shared memory (RES): loaded by 16-byte cp.async, all in flight at once,
// the maxima and live ranges taken there, exps in place; where two blocks
// an SM still fit with two buffers each (PF), as many blocks as fit on the
// card loop over the batch, each loading its next matrix while it works on
// this one.  Above MWD_LM_TK, a preparation kernel takes the maxima and
// ranges, and the block streams K in 32-deep tiles, double-buffered through
// registers: tile t + 1 is loaded while tile t is multiplied, then its exps
// are stored into the other buffer (one barrier a tile).  The guard's
// elements are summed by their own threads after the tile's other outputs
// are written (a warp's lanes over k measured slower on path 9, where the
// live k an element's row and column share are few).
//
// BF16 (dot_dtype="bfloat16") is the TPU kernel's factored form as it
// computes it: per K tile of MWD_LM_TK (BLOCK_K) the row and column maxima,
// exp(A - m_a) and exp(B - m_b) rounded to bf16 (nearest even) in shared
// memory, their product on the tensor cores (mma.sync.m16n8k16, bf16
// operands by ldmatrix, fp32 accumulators: a bf16 x bf16 product is exact in
// fp32, so only the order of the sums differs from the plain version), and
// the running (m, acc) combine per element across tiles.  It keeps that
// form's underflow, and is held to 5e-2 of the float32 kernel on 5 * normal
// inputs (tests/test_log_semiring_pallas.py).  A 64 x 64 block, 8 warps of
// 32 x 16 outputs.
//
// What bounds it on the H100: the float32 product's 2 I J K operations at
// the fp32 FMA rate where K is large (1024^3), the bytes where the matrices
// are small (path 9's S = 64); the bf16 variant's per-tile exps, maxima and
// combine (the tensor cores' share is small), and its bytes.

#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"

#define MWD_LM_NT 256
// K tile of the bf16 variant's maxima (ops/log_semiring.py BLOCK_K), and the
// largest K the float32 kernel keeps in shared memory whole.
#define MWD_LM_TK 128
#define MWD_LM_TKS 32  // the float32 kernel's streamed K tile

__device__ __forceinline__ bool mwd_lm_live(float m) { return m > MWD_NEG_INF / 2; }
__device__ __forceinline__ float mwd_lm_safe(float m) { return mwd_lm_live(m) ? m : 0.f; }

// An input as a sum of two takes it: -inf (and anything below NEG_INF) as
// NEG_INF, so sums of two stay finite; nan stays nan.
__device__ __forceinline__ float mwd_lm_load(float x) {
    return x < MWD_NEG_INF ? MWD_NEG_INF : x;
}

struct MwdLm {
    const float* a;  // batch of [I, K], rows contiguous
    const float* b;  // batch of [K, J], rows contiguous
    float* out;      // [nz, I, J]
    float* ws;       // the preparation kernel's maxima and ranges (streamed K)
    unsigned long long* guarded;  // [2]: elements that took the guard, and of them those
                                  // with a live term (summed again)
    long long nz, sa1, sa2, sb1, sb2;
    int nb2, ni, nk, nj, nkc;  // nkc: the preparation's K chunks of columns
    int vec_a, vec_b, vec_o;   // 16-byte rows of a, b and out
    float thresh;
};

__device__ __forceinline__ void mwd_lm_mats(const MwdLm& p, long long z, const float*& ap,
                                            const float*& bp) {
    const long long z1 = z / p.nb2, z2 = z - z1 * p.nb2;
    ap = p.a + z1 * p.sa1 + z2 * p.sa2;
    bp = p.b + z1 * p.sb1 + z2 * p.sb2;
}

// Four consecutive entries of a row of `len` (from `c`), NEG_INF past it or
// where the row does not exist; one 16-byte load where allowed.
__device__ __forceinline__ float4 mwd_lm_ld4(const float* row, int c, int len, bool ok, bool vec) {
    if (ok && vec && c + 3 < len) return __ldg(reinterpret_cast<const float4*>(row + c));
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = (ok && c + u < len) ? __ldg(row + c + u) : MWD_NEG_INF;
    return make_float4(v[0], v[1], v[2], v[3]);
}

// The same four entries into shared memory: a 16-byte cp.async where
// allowed (completed by mwd_lm_cp_wait), else a plain store.
__device__ __forceinline__ void mwd_lm_cp4(float* dst, const float* row, int c, int len, bool ok,
                                           bool vec) {
    if (ok && vec && c + 3 < len) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(row + c));
    } else {
        *reinterpret_cast<float4*>(dst) = mwd_lm_ld4(row, c, len, ok, false);
    }
}

// This thread's copies landed; with a barrier after it, everyone's.
__device__ __forceinline__ void mwd_lm_cp_wait() {
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n");
}

// exp(v - m), four at a time: the fast exp (ex2.approx) for the float32
// product; the correctly rounded expf where the result is rounded to bf16
// next (ACC), as the plain version's torch.exp, so the two round their
// operands alike.
template <bool ACC = false>
__device__ __forceinline__ float4 mwd_lm_exp4(float4 v, float4 m) {
    if constexpr (ACC)
        return make_float4(expf(v.x - m.x), expf(v.y - m.y), expf(v.z - m.z), expf(v.w - m.w));
    return make_float4(__expf(v.x - m.x), __expf(v.y - m.y), __expf(v.z - m.z),
                       __expf(v.w - m.w));
}

// A row's or column's maximum and its first and last live k, merged.
struct MwdLmStat {
    float m;
    int lo, hi;
};

__device__ __forceinline__ MwdLmStat mwd_lm_stat_empty() { return {MWD_NEG_INF, 1 << 30, -1}; }

__device__ __forceinline__ void mwd_lm_stat_add(MwdLmStat& s, float x, int k) {
    s.m = fmaxf(s.m, x);
    if (mwd_lm_live(x)) {
        s.lo = min(s.lo, k);
        s.hi = max(s.hi, k);
    }
}

__device__ __forceinline__ void mwd_lm_stat_merge(MwdLmStat& s, const MwdLmStat& o) {
    s.m = fmaxf(s.m, o.m);
    s.lo = min(s.lo, o.lo);
    s.hi = max(s.hi, o.hi);
}

// ---------------------------------------------------------------------------
// Preparation (float32, K > MWD_LM_TK): each row of a (a warp, lanes over k)
// and each column of b over a chunk of 256 k (32 columns x 8 row groups a
// block) into ws: rows [nz][I] then columns [nz][nkc][J], as MwdLmStat.
__global__ void __launch_bounds__(MWD_LM_NT) mwd_lm_prep_rows(MwdLm p) {
    MwdLmStat* st = reinterpret_cast<MwdLmStat*>(p.ws);
    const long long row = (long long)blockIdx.x * (MWD_LM_NT / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= p.nz * p.ni) return;
    const long long z = row / p.ni;
    const int i = (int)(row - z * p.ni);
    const float *ap, *bp;
    mwd_lm_mats(p, z, ap, bp);
    const float* r = ap + (long long)i * p.nk;
    MwdLmStat s = mwd_lm_stat_empty();
    for (int k = lane; k < p.nk; k += 32) mwd_lm_stat_add(s, __ldg(r + k), k);
    for (int o = 16; o > 0; o >>= 1) {
        MwdLmStat t{__shfl_xor_sync(0xffffffffu, s.m, o), __shfl_xor_sync(0xffffffffu, s.lo, o),
                    __shfl_xor_sync(0xffffffffu, s.hi, o)};
        mwd_lm_stat_merge(s, t);
    }
    if (lane == 0) st[row] = s;
}

#define MWD_LM_PREP_K 256
__global__ void __launch_bounds__(MWD_LM_NT) mwd_lm_prep_cols(MwdLm p) {
    __shared__ MwdLmStat part[8][32];
    MwdLmStat* st = reinterpret_cast<MwdLmStat*>(p.ws) + p.nz * p.ni;
    const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + c, kc = blockIdx.y;
    const long long z = blockIdx.z;
    const float *ap, *bp;
    mwd_lm_mats(p, z, ap, bp);
    MwdLmStat s = mwd_lm_stat_empty();
    if (j < p.nj) {
        const int k1 = min(p.nk, (kc + 1) * MWD_LM_PREP_K);
        for (int k = kc * MWD_LM_PREP_K + g; k < k1; k += 8)
            mwd_lm_stat_add(s, __ldg(bp + (long long)k * p.nj + j), k);
    }
    part[g][c] = s;
    __syncthreads();
    if (g == 0 && j < p.nj) {
        for (int q = 1; q < 8; ++q) mwd_lm_stat_merge(s, part[q][c]);
        st[(z * p.nkc + kc) * p.nj + j] = s;
    }
}

// ---------------------------------------------------------------------------
// Float32.  Shared memory: two of P [BM][pk] and of Q [TK][qk] (RES: this
// matrix's and the next one's; streamed: this K tile's and the next one's),
// then the block's rows' and columns' stats and (RES) the columns' partial
// stats.
template <int BM, int BN, int TM, int TN, bool RES, bool PF>
__global__ void __launch_bounds__(MWD_LM_NT, BM == 64 ? 3 : 2) mwd_lm_f32(MwdLm p) {
    static_assert(BM == 16 * TM && BN == 16 * TN && TM * TN <= 64, "tile");
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
    // K of a tile (RES: all of K, rounded up to 4), and the buffers' strides
    const int tk = RES ? (p.nk + 3) & ~3 : MWD_LM_TKS;
    const int pk = tk + 4, qk = BN + 4;
    constexpr int NBUF = RES && !PF ? 1 : 2;
    float* P = sm;
    float* Q = sm + NBUF * BM * pk;
    MwdLmStat* sa = reinterpret_cast<MwdLmStat*>(Q + NBUF * tk * qk);
    MwdLmStat* sb = sa + BM;
    MwdLmStat* sx = sb + BN;  // RES: the column stats' partials, [NT / BN - 1][BN]

    // RES: matrix zz's whole K, a's rows and b's rows, into buffer buf by
    // 16-byte cp.async, all in flight at once (one commit group)
    auto fetch = [&](long long zz, int buf) {
        const float *za, *zb;
        mwd_lm_mats(p, zz, za, zb);
        float *Pb = P + buf * BM * pk, *Qb = Q + buf * tk * qk;
        for (int q = tid; q < BM * (tk / 4); q += MWD_LM_NT) {
            const int ii = q / (tk / 4), k = 4 * (q - ii * (tk / 4)), i = i0 + ii;
            mwd_lm_cp4(Pb + ii * pk + k, za + (long long)i * p.nk, k, p.nk, i < p.ni, p.vec_a);
        }
        for (int q = tid; q < tk * (BN / 4); q += MWD_LM_NT) {
            const int k = q / (BN / 4), jj = 4 * (q - k * (BN / 4));
            mwd_lm_cp4(Qb + k * qk + jj, zb + (long long)k * p.nj, j0 + jj, p.nj, k < p.nk,
                       p.vec_b);
        }
        asm volatile("cp.async.commit_group;\n");
    };
    if constexpr (RES && PF)
        if (blockIdx.z < p.nz) fetch(blockIdx.z, 0);

    int it = 0;
    for (long long z = blockIdx.z; z < p.nz; z += gridDim.z, ++it) {
        const float *ap, *bp;
        mwd_lm_mats(p, z, ap, bp);
        __syncthreads();  // the previous matrix's readers are done
        if constexpr (RES) {
            // PF: the next matrix's loads go out before this one's work (a
            // block loops over the batch), then this one's are waited for
            const int cur = PF ? it & 1 : 0;
            float *Pc = P + cur * BM * pk, *Qc = Q + cur * tk * qk;
            if constexpr (PF) {
                if (z + gridDim.z < p.nz)
                    fetch(z + gridDim.z, cur ^ 1);
                else
                    asm volatile("cp.async.commit_group;\n");
                asm volatile("cp.async.wait_group 1;\n");
            } else {
                fetch(z, 0);
                asm volatile("cp.async.wait_group 0;\n");
            }
            __syncthreads();
            // maxima and live ranges: rows by NT / BM threads, columns by
            // NT / BN, merged through the stats' slots
            constexpr int GA = MWD_LM_NT / BM, GB = MWD_LM_NT / BN;
            {
                const int ii = tid / GA, g = tid % GA;
                MwdLmStat s = mwd_lm_stat_empty();
                for (int k = g; k < tk; k += GA) mwd_lm_stat_add(s, Pc[ii * pk + k], k);
#pragma unroll
                for (int o = GA / 2; o > 0; o >>= 1) {
                    MwdLmStat t{__shfl_xor_sync(0xffffffffu, s.m, o),
                                __shfl_xor_sync(0xffffffffu, s.lo, o),
                                __shfl_xor_sync(0xffffffffu, s.hi, o)};
                    mwd_lm_stat_merge(s, t);
                }
                if (g == 0) sa[ii] = s;
            }
            {
                const int jj = tid % BN, g = tid / BN;
                MwdLmStat s = mwd_lm_stat_empty();
                for (int k = g; k < tk; k += GB) mwd_lm_stat_add(s, Qc[k * qk + jj], k);
                if (g > 0) sx[(g - 1) * BN + jj] = s;
                __syncthreads();
                if (g == 0) {
                    for (int h = 1; h < GB; ++h) mwd_lm_stat_merge(s, sx[(h - 1) * BN + jj]);
                    sb[jj] = s;
                }
            }
            __syncthreads();
            for (int q = tid; q < BM * (tk / 4); q += MWD_LM_NT) {
                const int ii = q / (tk / 4), k = 4 * (q - ii * (tk / 4));
                const float m = mwd_lm_safe(sa[ii].m);
                float4* x = reinterpret_cast<float4*>(Pc + ii * pk + k);
                *x = mwd_lm_exp4(*x, make_float4(m, m, m, m));
            }
            for (int q = tid; q < tk * (BN / 4); q += MWD_LM_NT) {
                const int k = q / (BN / 4), jj = 4 * (q - k * (BN / 4));
                float4* x = reinterpret_cast<float4*>(Qc + k * qk + jj);
                *x = mwd_lm_exp4(*x, make_float4(mwd_lm_safe(sb[jj].m), mwd_lm_safe(sb[jj + 1].m),
                                                 mwd_lm_safe(sb[jj + 2].m),
                                                 mwd_lm_safe(sb[jj + 3].m)));
            }
            __syncthreads();
        } else {
            // the preparation's stats: rows, and columns merged over K chunks
            const MwdLmStat* st = reinterpret_cast<const MwdLmStat*>(p.ws);
            for (int ii = tid; ii < BM; ii += MWD_LM_NT)
                sa[ii] = i0 + ii < p.ni ? st[z * p.ni + i0 + ii] : mwd_lm_stat_empty();
            for (int jj = tid; jj < BN; jj += MWD_LM_NT) {
                MwdLmStat s = mwd_lm_stat_empty();
                if (j0 + jj < p.nj)
                    for (int kc = 0; kc < p.nkc; ++kc)
                        mwd_lm_stat_merge(s, st[p.nz * p.ni + (z * p.nkc + kc) * p.nj + j0 + jj]);
                sb[jj] = s;
            }
            __syncthreads();
        }

        float acc[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

        auto product = [&](const float* Pb, const float* Qb, int depth) {
#pragma unroll 2
            for (int kk = 0; kk < depth; kk += 4) {
                float4 pa[TM];
#pragma unroll
                for (int r = 0; r < TM; ++r)
                    pa[r] = *reinterpret_cast<const float4*>(Pb + (ty + 16 * r) * pk + kk);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    float qb[TN];
#pragma unroll
                    for (int c4 = 0; c4 < TN / 4; ++c4) {
                        const float4 v = *reinterpret_cast<const float4*>(
                            Qb + (kk + u) * qk + 4 * tx + 64 * c4);
                        qb[4 * c4] = v.x;
                        qb[4 * c4 + 1] = v.y;
                        qb[4 * c4 + 2] = v.z;
                        qb[4 * c4 + 3] = v.w;
                    }
#pragma unroll
                    for (int r = 0; r < TM; ++r) {
                        const float av = u == 0 ? pa[r].x : u == 1 ? pa[r].y : u == 2 ? pa[r].z
                                                                                       : pa[r].w;
#pragma unroll
                        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av, qb[c], acc[r][c]);
                    }
                }
            }
        };

        if constexpr (RES) {
            const int cur = PF ? it & 1 : 0;
            product(P + cur * BM * pk, Q + cur * tk * qk, tk);
        } else {
            // streamed: chunks of A's tile [BM][32] and B's [32][BN], BM / 32
            // and BN / 32 float4s a thread, loaded into registers a tile ahead
            constexpr int CA = BM * MWD_LM_TKS / 4 / MWD_LM_NT, CB = BN * MWD_LM_TKS / 4 / MWD_LM_NT;
            float4 ra[CA], rb[CB];
            auto load = [&](int k0) {
#pragma unroll
                for (int u = 0; u < CA; ++u) {
                    const int q = tid + u * MWD_LM_NT, ii = q >> 3, k = k0 + 4 * (q & 7);
                    ra[u] = mwd_lm_ld4(ap + (long long)(i0 + ii) * p.nk, k, p.nk, i0 + ii < p.ni,
                                       p.vec_a);
                }
#pragma unroll
                for (int u = 0; u < CB; ++u) {
                    const int q = tid + u * MWD_LM_NT, kk = q / (BN / 4), jj = 4 * (q % (BN / 4));
                    rb[u] = mwd_lm_ld4(bp + (long long)(k0 + kk) * p.nj, j0 + jj, p.nj,
                                       k0 + kk < p.nk, p.vec_b);
                }
            };
            auto store = [&](float* Pb, float* Qb) {
#pragma unroll
                for (int u = 0; u < CA; ++u) {
                    const int q = tid + u * MWD_LM_NT, ii = q >> 3, k = 4 * (q & 7);
                    const float m = mwd_lm_safe(sa[ii].m);
                    *reinterpret_cast<float4*>(Pb + ii * pk + k) =
                        mwd_lm_exp4(ra[u], make_float4(m, m, m, m));
                }
#pragma unroll
                for (int u = 0; u < CB; ++u) {
                    const int q = tid + u * MWD_LM_NT, kk = q / (BN / 4), jj = 4 * (q % (BN / 4));
                    *reinterpret_cast<float4*>(Qb + kk * qk + jj) = mwd_lm_exp4(
                        rb[u], make_float4(mwd_lm_safe(sb[jj].m), mwd_lm_safe(sb[jj + 1].m),
                                           mwd_lm_safe(sb[jj + 2].m), mwd_lm_safe(sb[jj + 3].m)));
                }
            };
            const int nt = (p.nk + MWD_LM_TKS - 1) / MWD_LM_TKS;
            load(0);
            store(P, Q);
            __syncthreads();
            for (int t = 0; t < nt; ++t) {
                const int cur = t & 1;
                if (t + 1 < nt) load((t + 1) * MWD_LM_TKS);
                product(P + cur * BM * pk, Q + cur * MWD_LM_TKS * qk, MWD_LM_TKS);
                if (t + 1 < nt) store(P + (cur ^ 1) * BM * pk, Q + (cur ^ 1) * MWD_LM_TKS * qk);
                __syncthreads();
            }
        }

        // out = M_i + N_j + log(acc); NEG_INF where a row or column is dead;
        // the guard's elements marked, written after the tile
        float* op = p.out + z * p.ni * (long long)p.nj;
        unsigned long long trip = 0;
        int n_took = 0;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const int ii = ty + 16 * r, i = i0 + ii;
            const MwdLmStat ra = sa[ii];
#pragma unroll
            for (int c4 = 0; c4 < TN / 4; ++c4) {
                const int jj = 4 * tx + 64 * c4, j = j0 + jj;
                float o[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float v = acc[r][4 * c4 + u];
                    o[u] = MWD_NEG_INF;
                    if (mwd_lm_live(ra.m) && mwd_lm_live(sb[jj + u].m)) {
                        if (!(v < p.thresh)) {
                            o[u] = ra.m + sb[jj + u].m + __logf(v);
                        } else if (i < p.ni && j + u < p.nj) {
                            // the guard; no live k in common: NEG_INF at once
                            ++n_took;
                            if (max(ra.lo, sb[jj + u].lo) <= min(ra.hi, sb[jj + u].hi))
                                trip |= 1ull << (r * TN + 4 * c4 + u);
                        }
                    }
                }
                if (i >= p.ni) continue;
                float* dst = op + (long long)i * p.nj + j;
                if (p.vec_o && j + 3 < p.nj) {
                    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
                } else {
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (j + u < p.nj) dst[u] = o[u];
                }
            }
        }
        // the guard: term by term over the k where the row and the column
        // are both live (a few, in a banded product), one exp a term against
        // the running maximum
        int n_trip = n_took, n_sum = __popcll(trip);
        while (trip) {
            const int e = __ffsll((long long)trip) - 1;
            trip &= trip - 1;
            const int ii = ty + 16 * (e / TN), jj = 4 * tx + 64 * (e % TN / 4) + e % 4;
            const int i = i0 + ii, j = j0 + jj;
            const int lo = max(sa[ii].lo, sb[jj].lo), hi = min(sa[ii].hi, sb[jj].hi);
            const float* ar = ap + (long long)i * p.nk;
            float m = -INFINITY, s = 0.f;
#pragma unroll 4
            for (int k = lo; k <= hi; ++k) {
                const float x = mwd_lm_load(__ldg(ar + k)) +
                                mwd_lm_load(__ldg(bp + (long long)k * p.nj + j));
                const float d = x - m;
                const float ex = __expf(-fabsf(d));
                s = d > 0.f ? fmaf(s, ex, 1.f) : s + ex;
                m = fmaxf(m, x);
            }
            op[(long long)i * p.nj + j] = mwd_lm_live(m) && s > 0.f ? m + logf(s) : MWD_NEG_INF;
        }
        for (int o = 16; o > 0; o >>= 1) {
            n_trip += __shfl_xor_sync(0xffffffffu, n_trip, o);
            n_sum += __shfl_xor_sync(0xffffffffu, n_sum, o);
        }
        if ((tid & 31) == 0 && n_trip > 0) {
            atomicAdd(p.guarded, (unsigned long long)n_trip);
            atomicAdd(p.guarded + 1, (unsigned long long)n_sum);
        }
    }
}

// ---------------------------------------------------------------------------
// BF16: per K tile of MWD_LM_TK, the tile's maxima, P and Q in bf16, the
// product by mma.sync, the running combine.  Shared memory: a's tile [64][TK
// + 4] and b's [TK][64 + 4] in fp32, P [64][TK + 8] and Q [TK][64 + 8] in
// bf16 (rows 16-byte aligned, 8 rows of an ldmatrix on distinct banks), the
// tile's maxima, and the column maxima's partials.
#define MWD_LM_B 64
#define MWD_LM_BPK (MWD_LM_TK + 4)
#define MWD_LM_BQK (MWD_LM_B + 4)
#define MWD_LM_HPK (MWD_LM_TK + 8)
#define MWD_LM_HQK (MWD_LM_B + 8)

__device__ __forceinline__ uint2 mwd_lm_bf16x4(float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void mwd_lm_ldsm4(uint32_t (&r)[4], const void* p, bool trans) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    if (trans)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(s));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(s));
}

__device__ __forceinline__ void mwd_lm_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MWD_LM_NT, 2) mwd_lm_bf16(MwdLm p) {
    extern __shared__ float4 smem4[];
    float* A = reinterpret_cast<float*>(smem4);      // [64][BPK]
    float* B = A + MWD_LM_B * MWD_LM_BPK;            // [TK][BQK]
    __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(B + MWD_LM_TK * MWD_LM_BQK);  // [64][HPK]
    __nv_bfloat16* Q = P + MWD_LM_B * MWD_LM_HPK;   // [TK][HQK]
    float* ma = reinterpret_cast<float*>(Q + MWD_LM_TK * MWD_LM_HQK);
    float* mb = ma + MWD_LM_B;
    float* part = mb + MWD_LM_B;  // [4][64] column maxima partials
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;  // rows 32 wm .., columns 16 wn ..
    const int i0 = blockIdx.y * MWD_LM_B, j0 = blockIdx.x * MWD_LM_B;

    for (long long z = blockIdx.z; z < p.nz; z += gridDim.z) {
        const float *ap, *bp;
        mwd_lm_mats(p, z, ap, bp);
        float m[2][2][4], s[2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    m[mt][nt][h] = MWD_NEG_INF;
                    s[mt][nt][h] = 0.f;
                }
        for (int k0 = 0; k0 < p.nk; k0 += MWD_LM_TK) {
            __syncthreads();  // the previous tile's readers are done
            // 8 16-byte chunks of each operand a thread, by cp.async
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int q = tid + u * MWD_LM_NT, ii = q >> 5, k = 4 * (q & 31);
                mwd_lm_cp4(A + ii * MWD_LM_BPK + k, ap + (long long)(i0 + ii) * p.nk, k0 + k,
                           p.nk, i0 + ii < p.ni, p.vec_a);
                const int kk = q >> 4, jj = 4 * (q & 15);
                mwd_lm_cp4(B + kk * MWD_LM_BQK + jj, bp + (long long)(k0 + kk) * p.nj, j0 + jj,
                           p.nj, k0 + kk < p.nk, p.vec_b);
            }
            mwd_lm_cp_wait();
            __syncthreads();
            {
                // row maxima: 4 threads a row, 32 k each; column maxima: 4
                // groups of 32 k over 64 columns
                const int ii = tid >> 2, h = tid & 3;
                float v = -INFINITY;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const float4 x =
                        *reinterpret_cast<const float4*>(A + ii * MWD_LM_BPK + 32 * h + 4 * u);
                    v = fmaxf(fmaxf(v, fmaxf(x.x, x.y)), fmaxf(x.z, x.w));
                }
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
                if (h == 0) ma[ii] = v;
                const int jj = tid & 63, gk = tid >> 6;
                float w = -INFINITY;
                for (int k = 32 * gk; k < 32 * gk + 32; ++k) w = fmaxf(w, B[k * MWD_LM_BQK + jj]);
                part[gk * MWD_LM_B + jj] = w;
            }
            __syncthreads();
            if (tid < MWD_LM_B)
                mb[tid] = fmaxf(fmaxf(part[tid], part[MWD_LM_B + tid]),
                                fmaxf(part[2 * MWD_LM_B + tid], part[3 * MWD_LM_B + tid]));
            __syncthreads();
            // P and Q rounded to bf16; a fully masked row / column has
            // maximum NEG_INF: shift by 0 so its exps are 0, as the TPU
            // kernel does
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int q = tid + u * MWD_LM_NT;
                const int ii = q >> 5, k = 4 * (q & 31);
                const float mr = mwd_lm_safe(ma[ii]);
                const float4 x = *reinterpret_cast<const float4*>(A + ii * MWD_LM_BPK + k);
                *reinterpret_cast<uint2*>(P + ii * MWD_LM_HPK + k) =
                    mwd_lm_bf16x4(mwd_lm_exp4<true>(x, make_float4(mr, mr, mr, mr)));
                const int kk = q >> 4, jj = 4 * (q & 15);
                const float4 y = *reinterpret_cast<const float4*>(B + kk * MWD_LM_BQK + jj);
                *reinterpret_cast<uint2*>(Q + kk * MWD_LM_HQK + jj) = mwd_lm_bf16x4(mwd_lm_exp4<true>(
                    y, make_float4(mwd_lm_safe(mb[jj]), mwd_lm_safe(mb[jj + 1]),
                                   mwd_lm_safe(mb[jj + 2]), mwd_lm_safe(mb[jj + 3]))));
            }
            __syncthreads();
            float c[2][2][4] = {};
#pragma unroll
            for (int ks = 0; ks < MWD_LM_TK / 16; ++ks) {
                uint32_t af[2][4], bf[4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mwd_lm_ldsm4(af[mt],
                                 P + (32 * wm + 16 * mt + (lane & 15)) * MWD_LM_HPK + 16 * ks +
                                     8 * (lane >> 4),
                                 false);
                mwd_lm_ldsm4(bf, Q + (16 * ks + (lane & 15)) * MWD_LM_HQK + 16 * wn + 8 * (lane >> 4),
                             true);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) mwd_lm_mma(c[mt][nt], af[mt], bf[2 * nt], bf[2 * nt + 1]);
            }
            // running combine: m' = max(m, m_t), acc' = acc exp(m - m') +
            // S_t exp(m_t - m'), with one exp; a tile whose row or column
            // is fully masked adds nothing
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int h = 0; h < 4; ++h) {
                        const float mar = ma[32 * wm + 16 * mt + g + 8 * (h >> 1)];
                        const float mbc = mb[16 * wn + 8 * nt + 2 * t4 + (h & 1)];
                        if (mwd_lm_live(mar) && mwd_lm_live(mbc)) {
                            const float mtile = mar + mbc, st = c[mt][nt][h];
                            const float d = mtile - m[mt][nt][h];
                            const float e = __expf(-fabsf(d));
                            if (d > 0.f) {
                                s[mt][nt][h] = fmaf(s[mt][nt][h], e, st);
                                m[mt][nt][h] = mtile;
                            } else {
                                s[mt][nt][h] = fmaf(st, e, s[mt][nt][h]);
                            }
                        }
                    }
        }
        float* op = p.out + z * p.ni * (long long)p.nj;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const int i = i0 + 32 * wm + 16 * mt + g + 8 * (h >> 1);
                    const int j = j0 + 16 * wn + 8 * nt + 2 * t4 + (h & 1);
                    if (i >= p.ni || j >= p.nj) continue;
                    const float mm = m[mt][nt][h], ss = s[mt][nt][h];
                    op[(long long)i * p.nj + j] =
                        mwd_lm_live(mm) && ss > 0.f ? mm + logf(fmaxf(ss, 1e-38f)) : MWD_NEG_INF;
                }
    }
}

// ---------------------------------------------------------------------------
// Host side.  The size class: 128 x 64 tiles where I > 64 and they give at
// least two blocks an SM, else 64 x 64.

static bool mwd_lm_large(long long nz, int ni, int nj) {
    const long long blocks = nz * ((ni + 127) / 128) * ((nj + 63) / 64);
    return ni > 64 && blocks >= 2LL * mwd_sms();
}

// Shared memory of a float32 launch: two buffers of P and Q (one where RES
// without PF), and the stats.
template <int BM, int BN, bool RES, bool PF>
static size_t mwd_lm_smem(int nk) {
    const int tk = RES ? (nk + 3) & ~3 : MWD_LM_TKS;
    return sizeof(float) * (RES && !PF ? 1 : 2) * ((size_t)BM * (tk + 4) + (size_t)tk * (BN + 4)) +
           sizeof(MwdLmStat) * (BM + 4 * BN);
}

// Floats of the preparation's workspace (0 where K fits one tile, or bf16).
extern "C" long long mwd_log_matmul_work(int nb1, int nb2, int ni, int nk, int nj, int bf16) {
    if (bf16 || nk <= MWD_LM_TK) return 0;
    const long long nz = (long long)nb1 * nb2;
    const int nkc = (nk + MWD_LM_PREP_K - 1) / MWD_LM_PREP_K;
    return (long long)sizeof(MwdLmStat) / 4 * nz * ((long long)ni + (long long)nkc * nj);
}

template <int BM, int BN, int TM, int TN, bool RES, bool PF>
static int mwd_lm_launch_f32(const MwdLm& p, dim3 grid, cudaStream_t stream) {
    const size_t smem = mwd_lm_smem<BM, BN, RES, PF>(p.nk);
    auto kernel = mwd_lm_f32<BM, BN, TM, TN, RES, PF>;
    int st = mwd_smem_optin(kernel, smem);
    if (st != 0) return st;
    grid.x = (p.nj + BN - 1) / BN;
    grid.y = (p.ni + BM - 1) / BM;
    if (PF) {
        // as many blocks as fit on the card at once, each looping over the
        // batch with the next matrix's loads in flight
        int per_sm = 1;
        st = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MWD_LM_NT,
                                                                smem);
        if (st != 0) return st;
        const long long fit = (long long)mwd_sms() * (per_sm > 0 ? per_sm : 1);
        long long gz = fit / ((long long)grid.x * grid.y);
        gz = gz < 1 ? 1 : gz;
        grid.z = (unsigned)(gz < grid.z ? gz : grid.z);
    }
    kernel<<<grid, MWD_LM_NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// RES: the next matrix's loads in flight (PF) where two blocks an SM still
// fit with both buffers, else one buffer.
template <int BM, int BN, int TM, int TN>
static int mwd_lm_launch_res(const MwdLm& p, dim3 grid, cudaStream_t stream) {
    if (mwd_lm_smem<BM, BN, true, true>(p.nk) <= MWD_SMEM_SM / 2 - 1024)
        return mwd_lm_launch_f32<BM, BN, TM, TN, true, true>(p, grid, stream);
    return mwd_lm_launch_f32<BM, BN, TM, TN, true, false>(p, grid, stream);
}

// ws: mwd_log_matmul_work floats (none needed: may be null); guarded: two
// unsigned 64-bit counters the float32 kernel adds its guard's elements to
// (all of them; those whose row and column have a live k in common);
// thresh: the guard's threshold.
extern "C" int mwd_log_matmul(const float* a, const float* b, float* out, float* ws,
                              unsigned long long* guarded, int nb1, int nb2, int ni, int nk,
                              int nj, long long sa1, long long sa2, long long sb1, long long sb2,
                              int bf16, float thresh, void* stream) {
    const long long nz = (long long)nb1 * nb2;
    if (nz == 0 || ni == 0 || nj == 0) return (int)cudaGetLastError();
    if (nb1 < 0 || nb2 < 1 || ni < 0 || nk < 0 || nj < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    MwdLm p;
    p.a = a;
    p.b = b;
    p.out = out;
    p.ws = ws;
    p.guarded = guarded;
    p.nz = nz;
    p.sa1 = sa1;
    p.sa2 = sa2;
    p.sb1 = sb1;
    p.sb2 = sb2;
    p.nb2 = nb2;
    p.ni = ni;
    p.nk = nk;
    p.nj = nj;
    p.nkc = (nk + MWD_LM_PREP_K - 1) / MWD_LM_PREP_K;
    // 16-byte rows: aligned base, and every row and matrix start a multiple
    // of 4 floats away from it
    auto al = [](const void* x) { return ((uintptr_t)x & 15) == 0; };
    p.vec_a = al(a) && nk % 4 == 0 && sa1 % 4 == 0 && sa2 % 4 == 0;
    p.vec_b = al(b) && nj % 4 == 0 && sb1 % 4 == 0 && sb2 % 4 == 0;
    p.vec_o = al(out) && nj % 4 == 0;
    p.thresh = thresh;
    const unsigned gz = (unsigned)(nz < 65535 ? nz : 65535);  // blocks loop over z beyond
    if (bf16) {
        const size_t smem = sizeof(float) * (MWD_LM_B * MWD_LM_BPK + MWD_LM_TK * MWD_LM_BQK) +
                            sizeof(__nv_bfloat16) *
                                (MWD_LM_B * MWD_LM_HPK + MWD_LM_TK * MWD_LM_HQK) +
                            sizeof(float) * 6 * MWD_LM_B;
        const int st = mwd_smem_optin(mwd_lm_bf16, smem);
        if (st != 0) return st;
        const dim3 grid((nj + MWD_LM_B - 1) / MWD_LM_B, (ni + MWD_LM_B - 1) / MWD_LM_B, gz);
        mwd_lm_bf16<<<grid, MWD_LM_NT, smem, s>>>(p);
        return (int)cudaGetLastError();
    }
    if (guarded == nullptr) return (int)cudaErrorInvalidValue;
    const bool res = nk <= MWD_LM_TK;
    if (!res) {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        const long long rows = nz * ni;
        const long long rb = (rows + MWD_LM_NT / 32 - 1) / (MWD_LM_NT / 32);
        if (rb >= (1LL << 31)) return (int)cudaErrorInvalidValue;
        mwd_lm_prep_rows<<<(unsigned)rb, MWD_LM_NT, 0, s>>>(p);
        if (nz >= 65536) return (int)cudaErrorInvalidValue;
        mwd_lm_prep_cols<<<dim3((nj + 31) / 32, p.nkc, (unsigned)nz), MWD_LM_NT, 0, s>>>(p);
        const int st = (int)cudaGetLastError();
        if (st != 0) return st;
    }
    const dim3 grid(1, 1, gz);
    if (mwd_lm_large(nz, ni, nj))
        return res ? mwd_lm_launch_res<128, 64, 8, 4>(p, grid, s)
                   : mwd_lm_launch_f32<128, 64, 8, 4, false, false>(p, grid, s);
    return res ? mwd_lm_launch_res<64, 64, 4, 4>(p, grid, s)
               : mwd_lm_launch_f32<64, 64, 4, 4, false, false>(p, grid, s);
}
