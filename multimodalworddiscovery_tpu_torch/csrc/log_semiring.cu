// K8: batched log-semiring matrix product,
// out[z, i, j] = logsumexp_k a[z, i, k] + b[z, k, j].
//
// Replaces multimodalworddiscovery_tpu/ops/log_semiring.py: log_matmul_pallas
// (_kernel), which is rank-2 (its callers vmap it) and streams K tiles in
// factored form: exp(A - m_a) @ exp(B - m_b) on the MXU with per-tile row
// maxima m_a and column maxima m_b, combined across tiles with a running
// maximum.  In float32 that factored form underflows: a term more than ~87
// nats below its tile's row maximum or column maximum becomes 0, even where
// it is the largest a[i, k] + b[k, j] of its (i, j), so a row that spans
// that much can lose its dominant term.  So the float32 kernel here
// computes what the broadcast oracle does (core/logsemiring.log_matmul),
// on every input: it streams K through
// shared memory and keeps, per output element, a running maximum m and the
// sum s of exp(x - m), one exp per term:
//
//   x = a + b;  d = x - m;  e = exp(-|d|);
//   d > 0 ? (s = s * e + 1, m = x) : (s = s + e)
//
// and writes m + log(s), or NEG_INF where m never rose above NEG_INF's level
// (a fully masked row or column).
//
// BF16 (dot_dtype="bfloat16") is the TPU kernel's factored form as it
// computes it: per K tile the row and column maxima, exp(A - m_a) and
// exp(B - m_b) rounded to bf16 (nearest even) in shared memory, their
// product summed in fp32 FMAs (a bf16 x bf16 product is exact in fp32), and
// the running (m, acc) combine across tiles.  It keeps that form's
// underflow, and is held to 5e-2 of the float32 kernel on 5 * normal inputs
// (tests/test_log_semiring_pallas.py).  Tensor cores are not used.
//
// What bounds it on the H100: operations, and among them the exps.  A term
// costs one exp (MUFU.EX2: 16 a clock per SM, an eighth of the 128 fp32
// FMAs) and about seven fp32 instructions, so the float32 kernel is bound by
// the SFU at I * J * K exps, eight times the 2 * I * J * K / fp32-rate bound
// of a plain product.  Each block computes a 64 x 64 output tile with 256
// threads, 4 x 4 outputs each (rows ty + 16 r and columns tx + 16 c, so the
// shared-memory reads of a warp broadcast without bank conflicts), and
// streams K in 32-deep tiles, A's tile stored transposed with a padded row.
// Positions outside [I, K, J] read NEG_INF, the identity of logsumexp.  The
// batch comes as two strided dimensions (z = z1 * nb2 + z2) over row-major
// matrices, so the strided even / odd slices of an associative scan over
// time reach the kernel as views, without copies.

#include <cuda_bf16.h>

#include "common.cuh"

#define MWD_LM_TI 64
#define MWD_LM_TJ 64
// K tile; ops/log_semiring.py BLOCK_K, where the bf16 variant's plain
// version takes its tile maxima over the same K tiles.
#define MWD_LM_TK 32
#define MWD_LM_THREADS 256

__device__ __forceinline__ float mwd_lm_safe(float m) { return m > MWD_NEG_INF / 2 ? m : 0.f; }

// An input as the tile holds it: -inf (and anything below NEG_INF) as
// NEG_INF, so sums of two stay finite; nan stays nan.
__device__ __forceinline__ float mwd_lm_load(float x) {
    return x < MWD_NEG_INF ? MWD_NEG_INF : x;
}

__device__ __forceinline__ float mwd_lm_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__global__ void __launch_bounds__(MWD_LM_THREADS) mwd_log_matmul_kernel(
    const float* __restrict__ a,  // batch of [I, K], rows contiguous
    const float* __restrict__ b,  // batch of [K, J], rows contiguous
    float* __restrict__ out,      // [nz, I, J]
    long long nz, int nb2, int ni, int nk, int nj,
    long long sa1, long long sa2, long long sb1, long long sb2) {
    __shared__ float as[MWD_LM_TK][MWD_LM_TI + 1];  // a's tile, transposed: as[k][i]
    __shared__ float bs[MWD_LM_TK][MWD_LM_TJ];
    __shared__ float ma[MWD_LM_TI], mb[MWD_LM_TJ];  // BF16: the tile's row / column maxima
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int i0 = blockIdx.y * MWD_LM_TI, j0 = blockIdx.x * MWD_LM_TJ;

    for (long long z = blockIdx.z; z < nz; z += gridDim.z) {
        const float* ap = a + (z / nb2) * sa1 + (z % nb2) * sa2;
        const float* bp = b + (z / nb2) * sb1 + (z % nb2) * sb2;
        float m[4][4], s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                m[r][c] = BF16 ? MWD_NEG_INF : -INFINITY;
                s[r][c] = 0.f;
            }

        for (int k0 = 0; k0 < nk; k0 += MWD_LM_TK) {
            __syncthreads();  // the previous tile's readers are done
            for (int q = tid; q < MWD_LM_TI * MWD_LM_TK; q += MWD_LM_THREADS) {
                const int kk = q % MWD_LM_TK, ii = q / MWD_LM_TK;  // a warp reads one row
                const int i = i0 + ii, k = k0 + kk;
                as[kk][ii] =
                    (i < ni && k < nk) ? mwd_lm_load(ap[(long long)i * nk + k]) : MWD_NEG_INF;
            }
            for (int q = tid; q < MWD_LM_TK * MWD_LM_TJ; q += MWD_LM_THREADS) {
                const int jj = q % MWD_LM_TJ, kk = q / MWD_LM_TJ;
                const int j = j0 + jj, k = k0 + kk;
                bs[kk][jj] =
                    (j < nj && k < nk) ? mwd_lm_load(bp[(long long)k * nj + j]) : MWD_NEG_INF;
            }
            __syncthreads();

            if constexpr (BF16) {
                if (tid < MWD_LM_TI) {
                    float v = -INFINITY;
                    for (int kk = 0; kk < MWD_LM_TK; ++kk) v = fmaxf(v, as[kk][tid]);
                    ma[tid] = v;
                } else if (tid < MWD_LM_TI + MWD_LM_TJ) {
                    float v = -INFINITY;
                    for (int kk = 0; kk < MWD_LM_TK; ++kk) v = fmaxf(v, bs[kk][tid - MWD_LM_TI]);
                    mb[tid - MWD_LM_TI] = v;
                }
                __syncthreads();
                // a fully masked row / column has maximum NEG_INF: shift by 0
                // so its exps are exp(NEG_INF) = 0, as the TPU kernel does
                for (int q = tid; q < MWD_LM_TI * MWD_LM_TK; q += MWD_LM_THREADS) {
                    const int kk = q % MWD_LM_TK, ii = q / MWD_LM_TK;
                    as[kk][ii] = mwd_lm_bf16(expf(as[kk][ii] - mwd_lm_safe(ma[ii])));
                }
                for (int q = tid; q < MWD_LM_TK * MWD_LM_TJ; q += MWD_LM_THREADS) {
                    const int jj = q % MWD_LM_TJ, kk = q / MWD_LM_TJ;
                    bs[kk][jj] = mwd_lm_bf16(expf(bs[kk][jj] - mwd_lm_safe(mb[jj])));
                }
                __syncthreads();
                float st[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) st[r][c] = 0.f;
#pragma unroll 8
                for (int kk = 0; kk < MWD_LM_TK; ++kk) {
                    float av[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) av[r] = as[kk][ty + 16 * r];
#pragma unroll
                    for (int c = 0; c < 4; ++c) bv[c] = bs[kk][tx + 16 * c];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) st[r][c] = fmaf(av[r], bv[c], st[r][c]);
                }
                // running combine: m' = max(m, m_t), acc' = acc exp(m - m') +
                // S_t exp(m_t - m'), with one exp; a tile whose row or column
                // is fully masked adds nothing
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const float mar = ma[ty + 16 * r], mbc = mb[tx + 16 * c];
                        if (mar > MWD_NEG_INF / 2 && mbc > MWD_NEG_INF / 2) {
                            const float mt = mar + mbc;
                            const float d = mt - m[r][c];
                            const float e = __expf(-fabsf(d));
                            if (d > 0.f) {
                                s[r][c] = fmaf(s[r][c], e, st[r][c]);
                                m[r][c] = mt;
                            } else {
                                s[r][c] = fmaf(st[r][c], e, s[r][c]);
                            }
                        }
                    }
            } else {
#pragma unroll 4
                for (int kk = 0; kk < MWD_LM_TK; ++kk) {
                    float av[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) av[r] = as[kk][ty + 16 * r];
#pragma unroll
                    for (int c = 0; c < 4; ++c) bv[c] = bs[kk][tx + 16 * c];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const float x = av[r] + bv[c];
                            const float d = x - m[r][c];
                            const float e = __expf(-fabsf(d));
                            const bool up = d > 0.f;
                            s[r][c] = up ? fmaf(s[r][c], e, 1.f) : s[r][c] + e;
                            m[r][c] = fmaxf(m[r][c], x);
                        }
                }
            }
        }

        float* op = out + z * ni * (long long)nj;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 16 * r;
            if (i >= ni) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = j0 + tx + 16 * c;
                if (j >= nj) continue;
                const bool live = m[r][c] > MWD_NEG_INF / 2 && s[r][c] > 0.f;
                op[(long long)i * nj + j] =
                    live ? m[r][c] + logf(fmaxf(s[r][c], 1e-38f)) : MWD_NEG_INF;
            }
        }
    }
}

extern "C" int mwd_log_matmul(const float* a, const float* b, float* out, int nb1, int nb2,
                              int ni, int nk, int nj, long long sa1, long long sa2,
                              long long sb1, long long sb2, int bf16, void* stream) {
    const long long nz = (long long)nb1 * nb2;
    if (nz == 0 || ni == 0 || nj == 0) return (int)cudaGetLastError();
    const long long gz = nz < 65535 ? nz : 65535;  // a block loops over z beyond this
    const dim3 grid((nj + MWD_LM_TJ - 1) / MWD_LM_TJ, (ni + MWD_LM_TI - 1) / MWD_LM_TI,
                    (unsigned)gz);
    if (bf16)
        mwd_log_matmul_kernel<true><<<grid, MWD_LM_THREADS, 0, (cudaStream_t)stream>>>(
            a, b, out, nz, nb2, ni, nk, nj, sa1, sa2, sb1, sb2);
    else
        mwd_log_matmul_kernel<false><<<grid, MWD_LM_THREADS, 0, (cudaStream_t)stream>>>(
            a, b, out, nz, nb2, ni, nk, nj, sa1, sa2, sb1, sb2);
    return (int)cudaGetLastError();
}
