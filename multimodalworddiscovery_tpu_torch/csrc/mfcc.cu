// K5: fused MFCC / log-mel features -> [M, n_out] float32.
//
// Replaces multimodalworddiscovery_tpu/ops/mfcc_pallas.py: mfcc_from_frames
// (body _kernel), and extract_pallas, which calls it.  Per frame:
// pre-emphasis, Hann window, the n_fft-point DFT of the zero-padded frame,
// power / n_fft, the triangular mel filterbank, log(max(mel, floor)), then
// the DCT-II (kind 'fbank' stops at the log-mels).  Everything stays on chip
// between one read of the samples and one write of the features.
//
// What bounds it on the H100: bytes.  At the pipeline's batch (N = 2000
// waveforms of L = 28,160 samples, 174 frames each, M = 348,000) the
// samples are 225 MB and the features 18 MB: 0.07 ms at 3.35 TB/s.  The
// TPU kernel ran the DFT as two dense [win, n_bins] cos/sin products on the
// matrix unit at HIGHEST precision (0.41 MFLOP a frame, 148 GFLOP here,
// >= 2.2 ms of fp32 FMAs); a real FFT needs about 15 kFLOP a frame (5 GFLOP)
// and a few KB of shared-memory traffic.  In practice that traffic sets the
// pace: a frame at n_fft = 512 takes about 260 shared-memory wavefronts (the
// FFT's three exchanges, its window and twiddle loads, the split, the mel
// sums), and the kernel runs near the SMs' one wavefront a clock, about 10x
// its byte bound (PERF.md).  No TF32, bf16 or __sinf anywhere:
// the reference requires full fp32 here (bf16 operands cost it 0.3 absolute
// in the MFCCs), and the twiddles are the host's float64 cos / sin rounded
// to fp32.  The design:
// - Framing and pre-emphasis here.  A block takes a run of up to 60
//   consecutive frames of one row (extract: a waveform, frame stride = hop;
//   mfcc_from_frames: the frames as one row, frame stride = win, no
//   pre-emphasis) and loads the run's sample span once, with 16-byte loads
//   aligned on the samples' addresses, applying y[t] = x[t] - coef x[t - 1]
//   (y = x at the start of a row) as the samples land in shared memory.
//   The samples are read about 1.04x, not the 2.5x of frame-by-frame loads,
//   and the pre-emphasized waveform never reaches device memory.
// - A warp a frame.  The DFT of the frame y (n_fft a power of two, 32 ..
//   2048) is a real FFT: z[m] = w y[2m] + i w y[2m + 1] (zero-padded to
//   N = n_fft / 2 points), a complex Stockham FFT of N points in radix-8
//   and radix-4 stages (log2 N = 3a + 2b), each lane taking N / 32 points a
//   stage in registers, one exchange through the warp's buffer in shared
//   memory per stage (index i + i / 8 in float2s, so the stride-8 stores of
//   the first stages meet no bank conflict), the twiddles of each stage laid
//   out by (j mod Ns, r) so a warp's loads are conflict-free; then the
//   split X[k] = (Z[k] + Z*[N - k]) / 2 - i W^k (Z[k] - Z*[N - k]) / 2,
//   each lane taking bins k and N - k from the same two loads.
// - Any other n_fft (win <= n_fft <= 2048) takes a direct DFT, a shape
//   choice inside the one C entry point, over the whole run at once: lanes
//   over frames (two a lane), each warp 8 bins at a time, so that every
//   twiddle load (one n_fft-entry (cos, sin) table, indexed by (t k) mod
//   n_fft kept incrementally, one step a pair of samples) is a broadcast
//   feeding 4 FMAs; the span is
//   staged with a float of padding every frame stride where that stride
//   is even, so the 32 frames a warp reads meet no bank conflict.  It is
//   folded where n_fft is even (bin n_fft/2 - k from bin k's twiddles up
//   to (-1)^t: E + O and E - O; bin n_fft/4 on its own where n_fft % 4 ==
//   0), unfolded where it is odd.  Its spectra go to a [frames, bins]
//   region, then each warp takes a frame's mel sums as below.
// - Then power / n_fft, each mel filter summed over its nonzero bins only
//   (the weights packed on the host, each filter cut into pieces so the
//   lanes' loops are about even), the log with the floor, the DCT-II
//   (its coefficients staged in shared memory);
//   the run's features are staged and written as one contiguous, coalesced
//   range of [M, n_out] rows, with no padded columns.  A run shrinks (fewer
//   frames) where its layout would pass the block's 227 KB (many mels, or
//   log-mel outputs).
// - Above n_fft = 2048, or where even a run of one frame does not fit, a
//   second kernel (mwd_mfcc_big) takes a frame a warp, a layout choice
//   inside the same entry point, so only the card's memory bounds n_fft,
//   win and n_mels: the tables are read through the cache, the frame's
//   pre-emphasized, windowed samples straight from the signal, and each
//   warp has a buffer of its own: a power of two keeps the real FFT, its
//   Stockham stages in the same radix-8 / radix-4 plan but between two
//   buffers (so a lane holds one butterfly at a time, whatever n_fft), any
//   other n_fft a direct DFT with lanes over bins (2 win (n_fft / 2 + 1)
//   FMAs a frame: slow, and correct).  As many warps a block as their
//   buffers fit (8 down to 1); where one warp's buffer passes 227 KB (a
//   power of two from n_fft = 32768) the buffers live in a workspace in
//   device memory, one slice a warp of a persistent grid.
// - win <= n_fft.

#include <stdint.h>

#include "common.cuh"

#define MWD_MFCC_NT 256        // 8 warps, a frame a warp at a time
#define MWD_MFCC_NW (MWD_MFCC_NT / 32)
#define MWD_MFCC_TF 60         // most frames of a block's run (3 blocks an SM)
#define MWD_MFCC_SPAN 12288    // most samples of a run's span (48 KB)
#define MWD_MFCC_RUN_NFFT 2048  // the largest n_fft of the run kernel (ops/mfcc.py RUN_N_FFT)
#define MWD_MFCC_DFT_NB 8      // base bins a warp takes a pass in the direct DFT
#define MWD_MFCC_DFT_PW 16384  // most floats of the direct DFT's power spectra
#define MWD_MFCC_DCT_SM 4096   // most DCT coefficients staged in shared memory

struct MwdMfcc {
    const float* sig;     // samples (see the header)
    const float2* tw;     // [n_fft] (cos, sin)(2 pi j / n_fft), staged twice over
                          // for the direct DFT
    const float2* stw;    // [n_stw] the FFT stages' twiddles, stage by stage
    const float* window;  // [win] symmetric Hann
    const float* fb_w;    // [n_fbw] each filter's weights over its bins [lo, hi)
    const int* fb_plan;   // [n_pieces, 4] (mel, lo, hi, offset into fb_w), then
                          // [n_mels + 1] each mel's first piece
    const float* dct;     // [n_mels, n_out] DCT-II transposed, or null: log-mels
    float* out;           // [n_rows * frames_per_row, n_out]
    long long row_stride, sig_len;
    int n_rows, frames_per_row, frame_stride, runs, tf, win, n_fft, n_stw, n_fbw, n_pieces, n_mels;
    int n_out, dct_sm, span_cap, bufsz;
    int dft, pad;  // the direct DFT (n_fft not a power of two), and its padded span
    float coef, log_floor;
};

__host__ __device__ static inline int mwd_round4(int x) { return (x + 3) & ~3; }

// Entries of the staged (cos, sin) table: the direct DFT holds it twice
// over.
__host__ __device__ static inline int mwd_mfcc_n_tw(const MwdMfcc& a) {
    return a.dft ? 2 * a.n_fft : a.n_fft;
}

// Float offsets of the shared-memory regions, each rounded up to 4 floats
// so that every region is 16-byte aligned; pw holds the direct DFT's power
// spectra [tf, n_bins].
struct MwdMfccLayout {
    int tw, stw, win, fbw, fbi, dct, span, pw, buf, out, total;
};

__host__ __device__ static inline MwdMfccLayout mwd_mfcc_layout(const MwdMfcc& a) {
    MwdMfccLayout L;
    L.tw = 0;
    L.stw = L.tw + mwd_round4(2 * mwd_mfcc_n_tw(a));
    L.win = L.stw + mwd_round4(2 * a.n_stw);
    L.fbw = L.win + mwd_round4((a.win > a.n_fft ? a.win : a.n_fft) + 2);
    L.fbi = L.fbw + mwd_round4(a.n_fbw);
    L.dct = L.fbi + mwd_round4(4 * a.n_pieces + a.n_mels + 1);
    L.span = L.dct + (a.dct_sm ? mwd_round4(a.n_mels * a.n_out) : 0);
    L.pw = L.span + a.span_cap;
    L.buf = L.pw + (a.dft ? mwd_round4(a.tf * (a.n_fft / 2 + 1)) : 0);
    L.out = L.buf + MWD_MFCC_NW * a.bufsz;
    L.total = L.out + a.tf * a.n_out;
    return L;
}

// The FFT plan of N = 2^LOGN complex points: a radix-8 stages, then b
// radix-4 (ops/mfcc.py fft_radices mirrors it; the host lays out the
// stages' twiddles in this order).
template <int LOGN>
struct MwdFftPlan {
    static constexpr int B4 = LOGN % 3 == 0 ? 0 : (LOGN % 3 == 2 ? 1 : 2);
    static constexpr int A8 = (LOGN - 2 * B4) / 3;
    static constexpr int STAGES = A8 + B4;
    __host__ __device__ static constexpr int radix(int s) { return s < A8 ? 8 : 4; }
    __host__ __device__ static constexpr int log_ns(int s) { return s <= A8 ? 3 * s : 3 * A8 + 2 * (s - A8); }
    // offset of stage s's twiddles [Ns, R - 1] (stage 0 has none)
    __host__ __device__ static constexpr int stw_off(int s) {
        int o = 0;
        for (int q = 1; q < s; ++q) o += (1 << log_ns(q)) * (radix(q) - 1);
        return o;
    }
};

__device__ __forceinline__ int mwd_pad(int i) { return i + (i >> 3); }
__device__ __forceinline__ float2 mwd_c_add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 mwd_c_sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
// a * conj(w): the forward DFT's e^{-i theta} from a (cos, sin) table entry
__device__ __forceinline__ float2 mwd_c_mul_conj(float2 a, float2 w) {
    return make_float2(fmaf(a.x, w.x, a.y * w.y), fmaf(a.y, w.x, -a.x * w.y));
}

// Forward DFT of 4 points in place, natural order.
__device__ __forceinline__ void mwd_dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
    const float2 t0 = mwd_c_add(a0, a2), t1 = mwd_c_sub(a0, a2);
    const float2 t2 = mwd_c_add(a1, a3), d = mwd_c_sub(a1, a3);
    const float2 t3 = make_float2(d.y, -d.x);  // -i d
    a0 = mwd_c_add(t0, t2);
    a2 = mwd_c_sub(t0, t2);
    a1 = mwd_c_add(t1, t3);
    a3 = mwd_c_sub(t1, t3);
}

template <int R>
__device__ __forceinline__ void mwd_dft(float2 (&v)[R]) {
    if constexpr (R == 4) {
        mwd_dft4(v[0], v[1], v[2], v[3]);
    } else {
        // two DFT-4s over the even and odd points, then W8^k = e^{-i pi k / 4}
        const float c = 0.70710678118654752f;  // cos(pi / 4) = sin(pi / 4), fp32
        mwd_dft4(v[0], v[2], v[4], v[6]);
        mwd_dft4(v[1], v[3], v[5], v[7]);
        const float2 o0 = v[1];
        const float2 o1 = make_float2(c * (v[3].x + v[3].y), c * (v[3].y - v[3].x));
        const float2 o2 = make_float2(v[5].y, -v[5].x);
        const float2 o3 = make_float2(c * (v[7].y - v[7].x), -c * (v[7].x + v[7].y));
        const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
        v[0] = mwd_c_add(e0, o0);
        v[4] = mwd_c_sub(e0, o0);
        v[1] = mwd_c_add(e1, o1);
        v[5] = mwd_c_sub(e1, o1);
        v[2] = mwd_c_add(e2, o2);
        v[6] = mwd_c_sub(e2, o2);
        v[3] = mwd_c_add(e3, o3);
        v[7] = mwd_c_sub(e3, o3);
    }
}

// One Stockham stage of N points, radix R, sub-transform size Ns = 2^LNS:
// butterfly j reads points j + r N / R, multiplies point r by
// conj(w)^(j mod Ns) r / (Ns R) (stw), and writes (j / Ns) Ns R + j mod Ns
// + r Ns.  The first stage (Ns = 1, no twiddles) packs the windowed frame.
template <int N, int R, int LNS, bool FIRST>
__device__ __forceinline__ void mwd_fft_stage(float2* z, const float2* stw, const float* y,
                                              const float* w, int win) {
    constexpr int NB = N / R, IT = (NB + 31) / 32, NS = 1 << LNS;
    const int lane = threadIdx.x & 31;
    float2 v[IT][R];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int jb = lane + 32 * i;
        if (NB % 32 == 0 || jb < NB) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int m = jb + r * NB;
                if constexpr (FIRST) {
                    const int t = 2 * m;
                    float2 p = make_float2(0.f, 0.f);
                    if (t + 1 < win) {
                        const float2 wp = *reinterpret_cast<const float2*>(w + t);
                        p = make_float2(y[t] * wp.x, y[t + 1] * wp.y);
                    } else if (t < win) {
                        p.x = y[t] * w[t];
                    }
                    v[i][r] = p;
                } else {
                    v[i][r] = z[mwd_pad(m)];
                }
            }
        }
    }
    if constexpr (!FIRST) __syncwarp();  // every point read before any is overwritten
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int jb = lane + 32 * i;
        if (NB % 32 == 0 || jb < NB) {
            const int jm = jb & (NS - 1);
            if constexpr (!FIRST) {
#pragma unroll
                for (int r = 1; r < R; ++r)
                    v[i][r] = mwd_c_mul_conj(v[i][r], stw[jm * (R - 1) + r - 1]);
            }
            mwd_dft<R>(v[i]);
            const int d = (jb >> LNS) * NS * R + jm;
#pragma unroll
            for (int r = 0; r < R; ++r) z[mwd_pad(d + r * NS)] = v[i][r];
        }
    }
    __syncwarp();
}

template <int LOGN, int S>
__device__ __forceinline__ void mwd_fft_stages(float2* z, const float2* stw, const float* y,
                                               const float* w, int win) {
    using P = MwdFftPlan<LOGN>;
    if constexpr (S < P::STAGES) {
        mwd_fft_stage<(1 << LOGN), P::radix(S), P::log_ns(S), S == 0>(z, stw + P::stw_off(S), y,
                                                                       w, win);
        mwd_fft_stages<LOGN, S + 1>(z, stw, y, w, win);
    }
}

// Power spectrum p[0 .. N] / n_fft of the frame y by the real FFT; the
// warp's buffer holds z (padded float2s), then p (floats) over it.
template <int LOGN>
__device__ __forceinline__ void mwd_power_fft(float* buf, const float* y, const float* w,
                                              int win, const float2* tw, const float2* stw) {
    constexpr int N = 1 << LOGN, NP = N / 2 + 1, IT = (NP + 31) / 32;
    float2* z = reinterpret_cast<float2*>(buf);
    mwd_fft_stages<LOGN, 0>(z, stw, y, w, win);
    const int lane = threadIdx.x & 31;
    const float inv = 1.f / (float)(2 * N);
    float pk[IT], pm[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int k = lane + 32 * i;
        if (NP % 32 == 0 || k < NP) {
            const float2 a = z[mwd_pad(k)], b = z[mwd_pad(k == 0 ? 0 : N - k)];
            const float2 w0 = tw[k];
            // X[k] from (Z[k], Z[N - k]) and X[N - k] from (Z[N - k], Z[k]):
            // E = (a + conj b) / 2, D = a - conj b, X = E - i W D / 2
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float2 p = h ? b : a, q = h ? a : b;
                // W^(N - k) = -conj(W^k): the table's (cos, sin) at N - k is
                // (-cos, sin) at k
                const float2 wk = h ? make_float2(-w0.x, w0.y) : w0;
                const float er = 0.5f * (p.x + q.x), ei = 0.5f * (p.y - q.y);
                const float dr = p.x - q.x, di = p.y + q.y;
                // W D with W = (cos, -sin); -i (x + i y) = y - i x
                const float wr = fmaf(wk.x, dr, wk.y * di), wi = fmaf(wk.x, di, -wk.y * dr);
                const float xr = fmaf(0.5f, wi, er), xi = fmaf(-0.5f, wr, ei);
                const float pw = fmaf(xr, xr, xi * xi) * inv;
                if (h)
                    pm[i] = pw;
                else
                    pk[i] = pw;
            }
        }
    }
    __syncwarp();  // z read in full before p overwrites it
#pragma unroll
    for (int i = 0; i < IT; ++i) {
        const int k = lane + 32 * i;
        if (NP % 32 == 0 || k < NP) {
            buf[k] = pk[i];
            buf[N - k] = pm[i];
        }
    }
}

// Power spectra / n_fft of the run's nf frames by the direct DFT, into pw
// [nf, n_bins].  Lanes over frames (lane and lane + 32), each warp a group
// of NB base bins at a time, so every twiddle load is a broadcast that
// feeds 4 FMAs, and a pair of samples (t, t + 1) takes one index step: E
// and O, the even and odd samples' partial sums.  Frame f's sample t sits
// at span + off + f sp + t + pad (t / stride) (the span's padded layout:
// sp = stride + pad is odd, so a warp's 32 frames meet no bank conflict);
// its samples are read in segments of `seg` (stride where padded, else the
// whole window).  FOLD (n even): base bins k < (n + 2) / 4 give bins k and
// n/2 - k (E + O and E - O: bin n/2 - k has bin k's twiddles up to
// (-1)^t), and where n % 4 == 0 bin n/4, its own partner, is one more
// task; otherwise every bin is E + O on its own.  The (cos, sin) table
// holds 2 n entries (the second copy spares the odd samples' index a wrap).
template <bool FOLD>
__device__ __forceinline__ void mwd_power_dft(float* pw, const float* span, int off, int sp,
                                              int seg, int pad, int nf, const float* w,
                                              int win, int n, const float2* tw) {
    constexpr int NB = MWD_MFCC_DFT_NB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_bins = n / 2 + 1;
    const float inv = 1.f / (float)n;
    const int nk = FOLD ? (n + 2) / 4 : n_bins;  // base bins
    const int ng = (nk + NB - 1) / NB;
    const int self = FOLD && n % 4 == 0;  // bin n/4 as a task of its own
    // frames past nf read frame nf - 1 and store nothing
    const float* y[2] = {span + off + min(lane, nf - 1) * sp,
                         span + off + min(lane + 32, nf - 1) * sp};
    for (int g = warp; g < ng + self; g += MWD_MFCC_NW) {
        if (g == ng) {
            // bin n/4: (t n/4) mod n = (t mod 4) n/4
            const int q = n / 4;
            float re[2] = {0.f, 0.f}, im[2] = {0.f, 0.f};
            for (int t0 = 0, p0 = 0; t0 < win; t0 += seg, p0 += seg + pad) {
                const int t1 = min(win, t0 + seg);
                for (int t = t0; t < t1; ++t) {
                    const float2 wt = tw[(t & 3) * q];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float x = y[h][p0 + t - t0] * w[t];
                        re[h] = fmaf(x, wt.x, re[h]);
                        im[h] = fmaf(x, wt.y, im[h]);
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (lane + 32 * h < nf)
                    pw[(lane + 32 * h) * n_bins + q] = (re[h] * re[h] + im[h] * im[h]) * inv;
            continue;
        }
        int k[NB], ie[NB], st[NB];
        float ec[2][NB], es[2][NB], oc[2][NB], os[2][NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            k[i] = min(g * NB + i, nk - 1);  // past nk: a copy, not stored
            ie[i] = 0;                         // (t k) mod n, t even
            st[i] = (2 * k[i]) % n;
#pragma unroll
            for (int h = 0; h < 2; ++h) ec[h][i] = es[h][i] = oc[h][i] = os[h][i] = 0.f;
        }
        for (int t0 = 0, p0 = 0; t0 < win; t0 += seg, p0 += seg + pad) {
            const int t1 = min(win, t0 + seg);
            // sample pairs (t, t + 1), one index step a pair; a segment
            // holds an even count of samples but perhaps the last
            int t = t0;
            for (; t + 1 < t1; t += 2) {
                const float2 wp = *reinterpret_cast<const float2*>(w + t);
                float xe[2], xo[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    xe[h] = y[h][p0 + t - t0] * wp.x;
                    xo[h] = y[h][p0 + t - t0 + 1] * wp.y;
                }
#pragma unroll
                for (int i = 0; i < NB; ++i) {
                    const float2 we = tw[ie[i]], wo = tw[ie[i] + k[i]];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        ec[h][i] = fmaf(xe[h], we.x, ec[h][i]);
                        es[h][i] = fmaf(xe[h], we.y, es[h][i]);
                        oc[h][i] = fmaf(xo[h], wo.x, oc[h][i]);
                        os[h][i] = fmaf(xo[h], wo.y, os[h][i]);
                    }
                    ie[i] += st[i];
                    ie[i] = ie[i] >= n ? ie[i] - n : ie[i];
                }
            }
            if (t < t1) {  // the window's last sample where win is odd: an even t, into E
                const float wt = w[t];
#pragma unroll
                for (int i = 0; i < NB; ++i) {
                    const float2 we = tw[ie[i]];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float x = y[h][p0 + t - t0] * wt;
                        ec[h][i] = fmaf(x, we.x, ec[h][i]);
                        es[h][i] = fmaf(x, we.y, es[h][i]);
                    }
                }
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int f = lane + 32 * h;
            if (f >= nf) continue;
#pragma unroll
            for (int i = 0; i < NB; ++i) {
                if (g * NB + i >= nk) continue;
                const float re = ec[h][i] + oc[h][i], im = es[h][i] + os[h][i];
                pw[f * n_bins + k[i]] = (re * re + im * im) * inv;
                if constexpr (FOLD) {
                    const float re2 = ec[h][i] - oc[h][i], im2 = es[h][i] - os[h][i];
                    pw[f * n_bins + n / 2 - k[i]] = (re2 * re2 + im2 * im2) * inv;
                }
            }
        }
    }
}

// LOGN > 0: the real FFT of n_fft = 2^(LOGN + 1) points; LOGN = 0: the
// direct DFT (FOLD: n_fft even).
template <int LOGN, bool FOLD>
__global__ void __launch_bounds__(MWD_MFCC_NT) mwd_mfcc_kernel(MwdMfcc a) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const MwdMfccLayout L = mwd_mfcc_layout(a);
    float2* tw_sh = reinterpret_cast<float2*>(sm + L.tw);
    float2* stw_sh = reinterpret_cast<float2*>(sm + L.stw);
    float* win_sh = sm + L.win;
    float* fbw_sh = sm + L.fbw;
    int* fbi_sh = reinterpret_cast<int*>(sm + L.fbi);
    float* dct_sh = sm + L.dct;
    float* span = sm + L.span;
    float* out_sh = sm + L.out;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    const int r = blockIdx.x / a.runs;
    const int j0 = (blockIdx.x - r * a.runs) * a.tf;
    const int nf = min(a.tf, a.frames_per_row - j0);
    const long long g = r * a.row_stride + (long long)j0 * a.frame_stride;  // first sample
    const int count = (nf - 1) * a.frame_stride + a.win;
    const int off = (int)(((uintptr_t)(a.sig + g) >> 2) & 3);
    const long long g0 = g - off;  // span[0]: 16-byte aligned in sig
    const long long pos0 = (long long)j0 * a.frame_stride - off;  // its position in the row

    for (int i = tid; i < mwd_mfcc_n_tw(a); i += MWD_MFCC_NT)
        tw_sh[i] = a.tw[i < a.n_fft ? i : i - a.n_fft];
    for (int i = tid; i < a.n_stw; i += MWD_MFCC_NT) stw_sh[i] = a.stw[i];
    for (int i = tid; i < a.n_fft + 2; i += MWD_MFCC_NT) win_sh[i] = i < a.win ? a.window[i] : 0.f;
    for (int i = tid; i < a.n_fbw; i += MWD_MFCC_NT) fbw_sh[i] = a.fb_w[i];
    for (int i = tid; i < 4 * a.n_pieces + a.n_mels + 1; i += MWD_MFCC_NT)
        fbi_sh[i] = a.fb_plan[i];
    if (a.dct_sm)
        for (int i = tid; i < a.n_mels * a.n_out; i += MWD_MFCC_NT) dct_sh[i] = a.dct[i];
    // the run's samples, pre-emphasized as they land; each thread has two
    // 16-byte chunks in flight.  Padded (the direct DFT, an even stride):
    // one float after every stride samples from span[off] on (the samples
    // before it are never read)
    const int nch = (off + count + 3) >> 2;
    for (int ch0 = tid; ch0 < nch; ch0 += 2 * MWD_MFCC_NT) {
        float x[2][5];  // samples gi - 1 .. gi + 3 of chunks ch0 and ch0 + NT
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const long long gi = g0 + 4LL * (ch0 + u * MWD_MFCC_NT);
            if (ch0 + u * MWD_MFCC_NT >= nch) continue;
            if (gi >= 1 && gi + 4 <= a.sig_len) {
                const float4 v = *reinterpret_cast<const float4*>(a.sig + gi);
                x[u][0] = a.sig[gi - 1];
                x[u][1] = v.x;
                x[u][2] = v.y;
                x[u][3] = v.z;
                x[u][4] = v.w;
            } else {
#pragma unroll
                for (int q = 0; q < 5; ++q) {
                    const long long idx = gi - 1 + q;
                    x[u][q] = (idx >= 0 && idx < a.sig_len) ? a.sig[idx] : 0.f;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int ch = ch0 + u * MWD_MFCC_NT;
            if (ch >= nch) continue;
            float yv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                yv[q] = pos0 + 4LL * ch + q == 0 ? x[u][q + 1] : x[u][q + 1] - a.coef * x[u][q];
            if (a.pad) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int i = 4 * ch + q - off;
                    if (i >= 0) span[off + i + i / a.frame_stride] = yv[q];
                }
            } else {
                *reinterpret_cast<float4*>(span + 4 * ch) = make_float4(yv[0], yv[1], yv[2], yv[3]);
            }
        }
    }
    __syncthreads();

    float* buf = sm + L.buf + warp * a.bufsz;
    const int n_bins = a.n_fft / 2 + 1;
    if constexpr (LOGN == 0) {
        mwd_power_dft<FOLD>(sm + L.pw, span, off, a.frame_stride + a.pad,
                            a.pad ? a.frame_stride : a.win, a.pad, nf, win_sh, a.win, a.n_fft,
                            tw_sh);
        __syncthreads();
    }
    // the DCT's coefficients from shared memory where they were staged
    const float* dct = a.dct_sm ? dct_sh : a.dct;
    for (int f = warp; f < nf; f += MWD_MFCC_NW) {
        // the frame's power spectrum: by the FFT into the warp's buffer, or
        // the direct DFT's row; then the mel scratch
        const float* pw = buf;
        float* lm = buf + n_bins;
        if constexpr (LOGN > 0) {
            mwd_power_fft<LOGN>(buf, span + off + f * a.frame_stride, win_sh, a.win, tw_sh,
                                stw_sh);
            __syncwarp();
        } else {
            pw = sm + L.pw + f * n_bins;
            lm = buf;
        }
        // mel sums over each filter's nonzero bins, in pieces of at most P
        // bins a lane (ops/mfcc.py mel_pieces evens out the lanes' work: at
        // the defaults the widest filter has 46 bins, a piece at most 9),
        // then each mel's pieces in order, and the log with the floor
        float* part = lm + a.n_mels;
        const int* first = fbi_sh + 4 * a.n_pieces;
        for (int q = lane; q < a.n_pieces; q += 32) {
            const int lo = fbi_sh[4 * q + 1], hi = fbi_sh[4 * q + 2];
            const float* wq = fbw_sh + fbi_sh[4 * q + 3] - lo;
            float acc = 0.f;
            for (int k = lo; k < hi; ++k) acc = fmaf(wq[k], pw[k], acc);
            part[q] = acc;
        }
        __syncwarp();
        for (int m = lane; m < a.n_mels; m += 32) {
            float acc = 0.f;
            for (int q = first[m]; q < first[m + 1]; ++q) acc += part[q];
            lm[m] = logf(fmaxf(acc, a.log_floor));
        }
        __syncwarp();
        // DCT-II, or the log-mels as they are
        for (int c = lane; c < a.n_out; c += 32) {
            float v = lm[c];
            if (dct != nullptr) {
                v = 0.f;
                for (int i = 0; i < a.n_mels; ++i) v = fmaf(dct[i * a.n_out + c], lm[i], v);
            }
            out_sh[f * a.n_out + c] = v;
        }
        __syncwarp();  // the buffer is free for the next frame
    }
    __syncthreads();
    float* dst = a.out + ((long long)r * a.frames_per_row + j0) * a.n_out;
    for (int i = tid; i < nf * a.n_out; i += MWD_MFCC_NT) dst[i] = out_sh[i];
}

// ---------------------------------------------------------------------------
// A frame a warp (n_fft above MWD_MFCC_RUN_NFFT, or a run of one frame too
// large for the block): the warp's buffer holds, for the FFT, two complex
// buffers of N = n_fft / 2 points (padded as mwd_pad) between which the
// Stockham stages go, then the power spectrum, the mel scratch and the
// pieces' partial sums over the second; for the direct DFT the frame's
// windowed samples, then those.
struct MwdMfccBig {
    int padn;   // complex entries of one FFT buffer
    int pw;     // float offset of the power spectrum in the warp's buffer
    int bufsz;  // floats a warp
    int nw;     // warps a block
    int ws;     // buffers in the workspace (else shared memory)
    long long grid;
};

// One Stockham stage between the warp's buffers, radix R, sub-transform
// size Ns = 2^lns, butterflies jb = lane, lane + 32, ..: as mwd_fft_stage,
// one butterfly at a time; FIRST packs the windowed frame (y: the row's
// samples from the frame's start, pre-emphasized on the fly).
template <int R, bool FIRST>
__device__ __forceinline__ void mwd_big_stage(float2* dst, const float2* src, const float2* stw,
                                              int n, int lns, const MwdMfcc& a, long long g,
                                              long long pos0) {
    const int nb = n / R, ns = 1 << lns, lane = threadIdx.x & 31;
    for (int jb = lane; jb < nb; jb += 32) {
        float2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int m = jb + r * nb;
            if constexpr (FIRST) {
                float y[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int t = 2 * m + h;
                    y[h] = 0.f;
                    if (t < a.win) {
                        float x = __ldg(a.sig + g + t);
                        if (pos0 + t > 0) x -= a.coef * __ldg(a.sig + g + t - 1);
                        y[h] = x * __ldg(a.window + t);
                    }
                }
                v[r] = make_float2(y[0], y[1]);
            } else {
                v[r] = src[mwd_pad(m)];
            }
        }
        const int jm = jb & (ns - 1);
        if constexpr (!FIRST) {
#pragma unroll
            for (int r = 1; r < R; ++r) v[r] = mwd_c_mul_conj(v[r], __ldg(stw + jm * (R - 1) + r - 1));
        }
        mwd_dft<R>(v);
        const int d = (jb >> lns) * ns * R + jm;
#pragma unroll
        for (int r = 0; r < R; ++r) dst[mwd_pad(d + r * ns)] = v[r];
    }
    __syncwarp();
}

template <bool FFT, bool WS>
__global__ void __launch_bounds__(MWD_MFCC_NT) mwd_mfcc_big(MwdMfcc a, MwdMfccBig b, float* ws) {
    extern __shared__ float4 smem4[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* buf = WS ? ws + ((long long)blockIdx.x * b.nw + warp) * b.bufsz
                    : reinterpret_cast<float*>(smem4) + warp * b.bufsz;
    const int n = a.n_fft, n_bins = n / 2 + 1;
    float* pw = buf + b.pw;
    float* lm = pw + mwd_round4(n_bins);
    float* part = lm + a.n_mels;
    const float inv = 1.f / (float)n;
    const long long total = (long long)a.n_rows * a.frames_per_row;
    for (long long m = (long long)blockIdx.x * b.nw + warp; m < total;
         m += (long long)gridDim.x * b.nw) {
        const long long r = m / a.frames_per_row;
        const long long pos0 = (m - r * a.frames_per_row) * a.frame_stride;  // in the row
        const long long g = r * a.row_stride + pos0;                         // in sig
        if constexpr (FFT) {
            // N = n / 2 complex points: radix-8 stages, then the one or two
            // radix-4 stages log2 N = 3 a8 + 2 b4 leaves (MwdFftPlan's plan)
            const int half = n / 2, logn = __ffs(half) - 1;
            const int b4 = logn % 3 == 0 ? 0 : (logn % 3 == 2 ? 1 : 2), a8 = (logn - 2 * b4) / 3;
            // the last stage writes z[0], so the power spectrum and the mel
            // scratch go over z[1]
            float2* z[2] = {reinterpret_cast<float2*>(buf),
                            reinterpret_cast<float2*>(buf) + b.padn};
            const int nst = a8 + b4;
            int lns = 0, off = 0;
            for (int st = 0; st < nst; ++st) {
                float2* dst = z[(nst - 1 - st) & 1];
                const float2* src = z[(nst - st) & 1];
                const float2* stw = a.stw + off;
                if (st == 0) {
                    if (a8 > 0)
                        mwd_big_stage<8, true>(dst, src, stw, half, 0, a, g, pos0);
                    else
                        mwd_big_stage<4, true>(dst, src, stw, half, 0, a, g, pos0);
                } else if (st < a8) {
                    mwd_big_stage<8, false>(dst, src, stw, half, lns, a, g, pos0);
                } else {
                    mwd_big_stage<4, false>(dst, src, stw, half, lns, a, g, pos0);
                }
                const int rad = st < a8 ? 8 : 4;
                if (st > 0) off += (1 << lns) * (rad - 1);
                lns += rad == 8 ? 3 : 2;
            }
            const float2* zf = z[0];
            const float inv2 = 1.f / (float)n;
            // the split, as mwd_power_fft: bins k and N - k from Z[k], Z[N - k]
            for (int k = lane; k <= half / 2; k += 32) {
                const float2 p0 = zf[mwd_pad(k)], q0 = zf[mwd_pad(k == 0 ? 0 : half - k)];
                const float2 w0 = __ldg(reinterpret_cast<const float2*>(a.tw) + k);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float2 p = h ? q0 : p0, q = h ? p0 : q0;
                    const float2 wk = h ? make_float2(-w0.x, w0.y) : w0;
                    const float er = 0.5f * (p.x + q.x), ei = 0.5f * (p.y - q.y);
                    const float dr = p.x - q.x, di = p.y + q.y;
                    const float wr = fmaf(wk.x, dr, wk.y * di), wi = fmaf(wk.x, di, -wk.y * dr);
                    const float xr = fmaf(0.5f, wi, er), xi = fmaf(-0.5f, wr, ei);
                    pw[h ? half - k : k] = fmaf(xr, xr, xi * xi) * inv2;
                }
            }
        } else {
            // the windowed frame, then a bin a lane: (t k) mod n stepped
            for (int t = lane; t < a.win; t += 32) {
                float x = __ldg(a.sig + g + t);
                if (pos0 + t > 0) x -= a.coef * __ldg(a.sig + g + t - 1);
                buf[t] = x * __ldg(a.window + t);
            }
            __syncwarp();
            for (int k = lane; k < n_bins; k += 32) {
                float re = 0.f, im = 0.f;
                int idx = 0;
#pragma unroll 4
                for (int t = 0; t < a.win; ++t) {
                    const float2 w = __ldg(reinterpret_cast<const float2*>(a.tw) + idx);
                    re = fmaf(buf[t], w.x, re);
                    im = fmaf(buf[t], w.y, im);
                    idx += k;
                    idx = idx >= n ? idx - n : idx;
                }
                pw[k] = (re * re + im * im) * inv;
            }
        }
        __syncwarp();
        // mel sums over the filters' pieces, each mel's pieces, the log
        const int* first = a.fb_plan + 4 * a.n_pieces;
        for (int q = lane; q < a.n_pieces; q += 32) {
            const int lo = __ldg(a.fb_plan + 4 * q + 1), hi = __ldg(a.fb_plan + 4 * q + 2);
            const float* wq = a.fb_w + __ldg(a.fb_plan + 4 * q + 3) - lo;
            float acc = 0.f;
#pragma unroll 8
            for (int k = lo; k < hi; ++k) acc = fmaf(__ldg(wq + k), pw[k], acc);
            part[q] = acc;
        }
        __syncwarp();
        for (int mm = lane; mm < a.n_mels; mm += 32) {
            float acc = 0.f;
            for (int q = __ldg(first + mm); q < __ldg(first + mm + 1); ++q) acc += part[q];
            lm[mm] = logf(fmaxf(acc, a.log_floor));
        }
        __syncwarp();
        float* dst = a.out + m * a.n_out;
        for (int c = lane; c < a.n_out; c += 32) {
            float v = lm[c];
            if (a.dct != nullptr) {
                v = 0.f;
#pragma unroll 8
                for (int i = 0; i < a.n_mels; ++i) v = fmaf(__ldg(a.dct + i * a.n_out + c), lm[i], v);
            }
            dst[c] = v;
        }
        __syncwarp();  // the buffer is free for the next frame
    }
}

typedef void (*MwdMfccKernel)(MwdMfcc);

static MwdMfccKernel mwd_mfcc_pick(int n_fft) {
    switch (n_fft) {
        case 32: return mwd_mfcc_kernel<4, false>;
        case 64: return mwd_mfcc_kernel<5, false>;
        case 128: return mwd_mfcc_kernel<6, false>;
        case 256: return mwd_mfcc_kernel<7, false>;
        case 512: return mwd_mfcc_kernel<8, false>;
        case 1024: return mwd_mfcc_kernel<9, false>;
        case 2048: return mwd_mfcc_kernel<10, false>;
        default: return n_fft % 2 == 0 ? mwd_mfcc_kernel<0, true> : mwd_mfcc_kernel<0, false>;
    }
}

// The run kernel's plan for runs of at most tf_max frames: frames a run,
// evened out over the row's runs (174 frames: 3 runs of 58), and the
// buffers' sizes; its shared memory in bytes.
static size_t mwd_mfcc_plan_runs(MwdMfcc& a, int tf_max) {
    const bool fft = !a.dft;
    const int n_bins = a.n_fft / 2 + 1;
    int tf = tf_max;
    a.runs = (a.frames_per_row + tf - 1) / tf;
    tf = (a.frames_per_row + a.runs - 1) / a.runs;
    a.tf = tf;
    // the staged chunks cover [off, off + count) rounded out to 4 samples,
    // plus a float of padding every frame_stride of them
    const int count = (tf - 1) * a.frame_stride + a.win;
    a.span_cap = mwd_round4(count + 8 + (a.pad ? (count + 8) / a.frame_stride + 1 : 0));
    const int half = a.n_fft / 2;
    const int z = fft ? 2 * (half + half / 8) : 0;
    const int p = (fft ? n_bins : 0) + a.n_mels + a.n_pieces;
    a.bufsz = mwd_round4(z > p ? z : p);
    return (size_t)mwd_mfcc_layout(a).total * sizeof(float);
}

// The frame-a-warp kernel's plan: its buffers, warps a block (as many of
// them as fit, at most 8; none fits: the workspace, 8 warps, a block an
// SM).
static MwdMfccBig mwd_mfcc_plan_big(const MwdMfcc& a, int sms) {
    MwdMfccBig b;
    const int n_bins = a.n_fft / 2 + 1, half = a.n_fft / 2;
    const int scratch = mwd_round4(n_bins) + a.n_mels + a.n_pieces;
    b.padn = a.dft ? 0 : half + half / 8;
    b.pw = a.dft ? mwd_round4(a.win) : 2 * b.padn;  // the FFT: over the second buffer
    b.bufsz = mwd_round4(b.pw + (a.dft || scratch > 2 * b.padn ? scratch : 2 * b.padn));
    const long long fit = MWD_SMEM_OPTIN_MAX / ((long long)b.bufsz * sizeof(float));
    b.ws = fit < 1;
    b.nw = b.ws || fit > MWD_MFCC_NW ? MWD_MFCC_NW : (int)fit;
    const long long frames = (long long)a.n_rows * a.frames_per_row;
    b.grid = (frames + b.nw - 1) / b.nw;
    const long long cap = (long long)sms * (b.ws ? 1 : 32);
    b.grid = b.grid < cap ? b.grid : cap;
    return b;
}

// Fill a from the entry point's arguments; the run kernel's plan where
// n_fft <= MWD_MFCC_RUN_NFFT and some run fits the block, else big->ws set
// by mwd_mfcc_plan_big (return: 1 for the frame-a-warp kernel).
static int mwd_mfcc_plan(MwdMfcc& a, MwdMfccBig& big, size_t& smem, int win, int n_fft,
                         int n_stw, int n_fbw, int n_pieces, int n_mels, int n_out, int do_dct) {
    const bool fft = n_fft >= 32 && (n_fft & (n_fft - 1)) == 0;
    a.win = win;
    a.n_fft = n_fft;
    a.n_stw = fft ? n_stw : 0;
    a.n_fbw = n_fbw;
    a.n_pieces = n_pieces;
    a.n_mels = n_mels;
    a.n_out = n_out;
    a.dct_sm = do_dct && n_mels * n_out <= MWD_MFCC_DCT_SM;
    // the direct DFT pads its span where the stride is even, so the frames'
    // stride in shared memory is odd
    a.dft = !fft;
    a.pad = !fft && a.frame_stride % 2 == 0;
    if (n_fft <= MWD_MFCC_RUN_NFFT) {
        // frames a run: within the span's budget (and the direct DFT's power
        // spectra's), then fewer while the layout passes the block's limit
        const int n_bins = n_fft / 2 + 1;
        int tf = (MWD_MFCC_SPAN - win) / a.frame_stride + 1;
        if (!fft && tf > MWD_MFCC_DFT_PW / n_bins) tf = MWD_MFCC_DFT_PW / n_bins;
        tf = tf < 1 ? 1 : (tf > MWD_MFCC_TF ? MWD_MFCC_TF : tf);
        for (;; tf = tf / 2) {
            smem = mwd_mfcc_plan_runs(a, tf);
            if (smem <= MWD_SMEM_OPTIN_MAX) return 0;
            if (tf == 1) break;
        }
    }
    big = mwd_mfcc_plan_big(a, mwd_sms());
    smem = big.ws ? 0 : (size_t)big.nw * big.bufsz * sizeof(float);
    return 1;
}

// Floats of the workspace mwd_mfcc needs (0: none).
extern "C" long long mwd_mfcc_work(int n_rows, int frames_per_row, int frame_stride, int win,
                                   int n_fft, int n_stw, int n_fbw, int n_pieces, int n_mels,
                                   int n_out, int do_dct) {
    MwdMfcc a;
    a.n_rows = n_rows;
    a.frames_per_row = frames_per_row;
    a.frame_stride = frame_stride < 1 ? 1 : frame_stride;
    MwdMfccBig big;
    size_t smem = 0;
    if ((long long)n_rows * frames_per_row == 0 || n_fft < 1 || win < 1 ||
        !mwd_mfcc_plan(a, big, smem, win, n_fft, n_stw, n_fbw, n_pieces, n_mels, n_out, do_dct) ||
        !big.ws)
        return 0;
    return big.grid * big.nw * (long long)big.bufsz;
}

// Frame m = (row r, index j) starts at sig + r * row_stride + j *
// frame_stride; sig_len samples are readable from sig.  coef is the
// pre-emphasis (0: off).  n_stw: the FFT stages' twiddles (ignored by the
// direct DFT).  fb_plan: the filters' pieces and each mel's first piece (ops/mfcc.py
// mel_pieces).  dct is [n_mels, n_out], used when do_dct.  ws:
// mwd_mfcc_work floats (may be null where that is 0).
extern "C" int mwd_mfcc(const float* sig, const float* tw, const float* stw, const float* window,
                        const float* fb_w, const int* fb_plan, const float* dct, float* out,
                        float* ws, int n_rows, int frames_per_row, long long row_stride,
                        int frame_stride, long long sig_len, int win, int n_fft, int n_stw,
                        int n_fbw, int n_pieces, int n_mels, int n_out, int do_dct, float coef,
                        float log_floor, void* stream) {
    if (n_fft < 1 || win < 1 || win > n_fft || n_mels < 1 || n_out < 1 || n_out > n_mels
        || n_rows < 0 || frames_per_row < 0 || row_stride < 0 || frame_stride < 1 || n_stw < 0
        || n_fbw < 0 || n_pieces < 0)
        return (int)cudaErrorInvalidValue;
    if ((long long)n_rows * frames_per_row == 0) return (int)cudaGetLastError();
    MwdMfcc a;
    a.sig = sig;
    a.tw = (const float2*)tw;
    a.stw = (const float2*)stw;
    a.window = window;
    a.fb_w = fb_w;
    a.fb_plan = fb_plan;
    a.dct = do_dct ? dct : nullptr;
    a.out = out;
    a.row_stride = row_stride;
    a.sig_len = sig_len;
    a.n_rows = n_rows;
    a.frames_per_row = frames_per_row;
    a.frame_stride = frame_stride;
    a.coef = coef;
    a.log_floor = log_floor;
    const bool fft = n_fft >= 32 && (n_fft & (n_fft - 1)) == 0;
    if (fft && n_stw < 1) return (int)cudaErrorInvalidValue;
    MwdMfccBig big;
    size_t smem = 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (mwd_mfcc_plan(a, big, smem, win, n_fft, n_stw, n_fbw, n_pieces, n_mels, n_out, do_dct)) {
        if (big.ws && ws == nullptr) return (int)cudaErrorInvalidValue;
        void (*kernel)(MwdMfcc, MwdMfccBig, float*) =
            fft ? (big.ws ? &mwd_mfcc_big<true, true> : &mwd_mfcc_big<true, false>)
                : (big.ws ? &mwd_mfcc_big<false, true> : &mwd_mfcc_big<false, false>);
        const int st = mwd_smem_optin(kernel, smem);
        if (st != 0) return st;
        kernel<<<(unsigned)big.grid, 32 * big.nw, smem, s>>>(a, big, ws);
        return (int)cudaGetLastError();
    }
    const long long blocks = (long long)n_rows * a.runs;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const MwdMfccKernel kernel = mwd_mfcc_pick(n_fft);
    const int st = mwd_smem_optin(kernel, smem);
    if (st != 0) return st;
    kernel<<<(unsigned)blocks, MWD_MFCC_NT, smem, s>>>(a);
    return (int)cudaGetLastError();
}
