// K5: fused MFCC / log-mel features -> [M, n_out] float32.
//
// Replaces multimodalworddiscovery_tpu/ops/mfcc_pallas.py: mfcc_from_frames
// (body _kernel), and extract_pallas, which calls it.  Per frame: Hann
// window, the n_fft-point DFT of the zero-padded frame, power / n_fft, the
// triangular mel filterbank, log(max(mel, floor)), then the DCT-II
// (kind 'fbank' stops at the log-mels).  Everything stays on chip between
// one read of the samples and one write of the features.
//
// Framing happens here: frame m = (row r, index j) starts at
// sig + r * row_stride + j * frame_stride.  extract passes the
// pre-emphasized waveform with frame_stride = hop, so the 2.5x overlapping
// frame tensor never exists; mfcc_from_frames passes one frame per row.
//
// What bounds it on the H100: arithmetic.  The TPU kernel ran the DFT as
// two dense [win, n_bins] cos/sin products on the matrix unit at HIGHEST
// precision; a dense fp32 DFT is 2 * 400 * 257 * 2 = 0.41 MFLOP per frame,
// about 148 GFLOP at the pipeline's batch (N = 2000, L = 28,160 samples,
// 174 frames each, M = 348,000), >= 2.2 ms at 67 TFLOP/s fp32, while its
// bytes (225 MB of samples read, 18 MB written) take 0.07 ms at
// 3.35 TB/s.  No TF32 or bf16 anywhere: the reference requires full fp32
// here, and operand rounding to bf16 cost 0.3 absolute in the MFCCs.
// The design:
// - Twiddles: one n_fft-entry (cos, sin) table in shared memory indexed by
//   (t * k) & (n_fft - 1), instead of the dense [win, n_bins] tables
//   (822 KB at the defaults, beyond shared memory).  The values are the
//   host's float64 cos/sin rounded to fp32, as in the reference's tables.
// - Folding: bin n_fft/2 - k shares bin k's twiddles up to (-1)^t, so one
//   pass over the even and the odd samples gives both bins (E + O and
//   E - O).  Base bins 0 .. n_fft/4 - 1 cover every bin but n_fft/4, which
//   a short second pass adds.  That halves the DFT to 0.2 MFLOP per frame.
// - Layout: a block stages 64 windowed frames in shared memory (row stride
//   == 2 mod 4 floats, so the 8-byte loads of 32 frames hit distinct banks)
//   and its 16 warps each take 8 base bins; a lane owns two frames, so each
//   broadcast twiddle load feeds four FMAs and each pair of samples feeds
//   32.  The power spectrum then overwrites the frames in shared memory,
//   the mel sums run over each filter's nonzero bins only, and the DCT
//   writes [M, n_out] rows with no padded columns.
// - Limits: n_fft a power of two in [32, 512] (16 warps x 8 bins cover
//   n_fft / 4), win <= n_fft, n_mels <= 256.
// A shared-memory FFT (about 20x fewer operations) or a split-precision
// tensor-core DFT is later work.

#include <stdint.h>

#include "common.cuh"

#define MWD_MFCC_TF 64         // frames per block (two per lane)
#define MWD_MFCC_THREADS 512   // 16 warps, one group of base bins each
#define MWD_MFCC_NB 8          // base bins per warp
#define MWD_MFCC_MAX_NFFT 512  // MWD_MFCC_THREADS / 32 * MWD_MFCC_NB * 4
#define MWD_MFCC_MAX_MELS 256

// Row stride of the staged frames: >= win + 1 (the odd sample of the last
// pair reads a zero), even, and == 2 mod 4.
__host__ __device__ static inline int mwd_mfcc_xs(int win) {
    int xs = (win + 2) & ~1;
    if ((xs & 3) == 0) xs += 2;
    return xs;
}

// Floats per frame of the staging region: the frame, or later the power
// spectrum [n_bins] followed by the log-mels [n_mels + 1].
static int mwd_mfcc_region(int win, int n_bins, int n_mels) {
    const int xs = mwd_mfcc_xs(win);
    const int after = n_bins + n_mels + 1;
    return xs > after ? xs : after;
}

static size_t mwd_mfcc_smem(int win, int n_fft, int n_mels) {
    const int n_bins = n_fft / 2 + 1;
    return ((size_t)2 * n_fft + (size_t)MWD_MFCC_TF * mwd_mfcc_region(win, n_bins, n_mels))
           * sizeof(float);
}

__global__ void __launch_bounds__(MWD_MFCC_THREADS, 1) mwd_mfcc_kernel(
    const float* __restrict__ sig,      // samples (see header)
    const float2* __restrict__ tw,      // [n_fft] (cos, sin)(2 pi j / n_fft)
    const float* __restrict__ window,   // [win] symmetric Hann
    const float* __restrict__ fb,       // [n_mels, n_bins] mel filters
    const int* __restrict__ fb_range,   // [n_mels, 2] nonzero bins [lo, hi)
    const float* __restrict__ dct,      // [n_out, n_mels], or null: log-mels
    float* __restrict__ out,            // [M, n_out]
    long long m_total, int frames_per_row, long long row_stride, long long frame_stride,
    int win, int n_fft, int n_mels, int n_out, float log_floor) {
    extern __shared__ float smem[];
    float2* tw_sh = (float2*)smem;  // [n_fft]
    float* x_sh = smem + 2 * n_fft;  // [TF, xs] frames; later power and log-mels
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int n_bins = n_fft / 2 + 1;
    const int quarter = n_fft / 4;
    const int mask = n_fft - 1;
    const int xs = mwd_mfcc_xs(win);
    const long long tile0 = (long long)blockIdx.x * MWD_MFCC_TF;

    for (int i = tid; i < n_fft; i += blockDim.x) tw_sh[i] = tw[i];
    for (int f = warp; f < MWD_MFCC_TF; f += nwarps) {
        const long long m = tile0 + f;
        const float* src = nullptr;
        if (m < m_total) {
            const long long r = m / frames_per_row;
            src = sig + r * row_stride + (m - r * frames_per_row) * frame_stride;
        }
        for (int t = lane; t < xs; t += 32)
            x_sh[f * xs + t] = (src != nullptr && t < win) ? src[t] * window[t] : 0.f;
    }
    __syncthreads();

    // DFT of base bins k0 .. k0 + NB - 1 for frames lane and lane + 32:
    // even / odd partial sums of x * cos and x * sin.
    const bool dft = warp * MWD_MFCC_NB < quarter;
    const int k0 = warp * MWD_MFCC_NB;
    float pw[2][MWD_MFCC_NB][2];  // power of bin k and of bin n_fft/2 - k
    if (dft) {
        float ec[2][MWD_MFCC_NB], oc[2][MWD_MFCC_NB], es[2][MWD_MFCC_NB], os[2][MWD_MFCC_NB];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < MWD_MFCC_NB; ++j) ec[r][j] = oc[r][j] = es[r][j] = os[r][j] = 0.f;
        const float* x0 = x_sh + lane * xs;
        const float* x1 = x_sh + (lane + 32) * xs;
        for (int t = 0; t < win; t += 2) {
            const float2 a = *(const float2*)(x0 + t);  // samples t, t + 1 of frame lane
            const float2 b = *(const float2*)(x1 + t);  // ... of frame lane + 32
#pragma unroll
            for (int j = 0; j < MWD_MFCC_NB; ++j) {
                const int k = k0 + j;
                const float2 we = tw_sh[(t * k) & mask];
                const float2 wo = tw_sh[((t + 1) * k) & mask];
                ec[0][j] = fmaf(a.x, we.x, ec[0][j]);
                es[0][j] = fmaf(a.x, we.y, es[0][j]);
                oc[0][j] = fmaf(a.y, wo.x, oc[0][j]);
                os[0][j] = fmaf(a.y, wo.y, os[0][j]);
                ec[1][j] = fmaf(b.x, we.x, ec[1][j]);
                es[1][j] = fmaf(b.x, we.y, es[1][j]);
                oc[1][j] = fmaf(b.y, wo.x, oc[1][j]);
                os[1][j] = fmaf(b.y, wo.y, os[1][j]);
            }
        }
        const float inv = 1.f / (float)n_fft;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < MWD_MFCC_NB; ++j) {
                const float re = ec[r][j] + oc[r][j], im = es[r][j] + os[r][j];
                const float re2 = ec[r][j] - oc[r][j], im2 = es[r][j] - os[r][j];
                pw[r][j][0] = (re * re + im * im) * inv;
                pw[r][j][1] = (re2 * re2 + im2 * im2) * inv;
            }
    }
    // bin n_fft / 4, its own partner: one thread per frame
    float pq = 0.f;
    if (tid < MWD_MFCC_TF) {
        const float* x = x_sh + tid * xs;
        float re = 0.f, im = 0.f;
        for (int t = 0; t < win; ++t) {
            const float2 w = tw_sh[(t * quarter) & mask];
            re = fmaf(x[t], w.x, re);
            im = fmaf(x[t], w.y, im);
        }
        pq = (re * re + im * im) * (1.f / (float)n_fft);
    }
    __syncthreads();  // the frames are no longer read

    float* pw_sh = x_sh;                              // [TF, n_bins]
    float* mel_sh = x_sh + MWD_MFCC_TF * n_bins;      // [TF, n_mels + 1]
    if (dft) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < MWD_MFCC_NB; ++j) {
                const int f = lane + 32 * r;
                pw_sh[f * n_bins + k0 + j] = pw[r][j][0];
                pw_sh[f * n_bins + n_fft / 2 - (k0 + j)] = pw[r][j][1];
            }
    }
    if (tid < MWD_MFCC_TF) pw_sh[tid * n_bins + quarter] = pq;
    __syncthreads();

    // mel sums over each filter's nonzero bins, then log with the floor;
    // a warp's lanes share a filter and take consecutive frames
    for (int p = tid; p < MWD_MFCC_TF * n_mels; p += blockDim.x) {
        const int f = p % MWD_MFCC_TF;
        const int mel = p / MWD_MFCC_TF;
        const int hi = fb_range[2 * mel + 1];
        const float* w = fb + (long long)mel * n_bins;
        const float* pr = pw_sh + f * n_bins;
        float acc = 0.f;
        for (int k = fb_range[2 * mel]; k < hi; ++k) acc = fmaf(w[k], pr[k], acc);
        mel_sh[f * (n_mels + 1) + mel] = logf(fmaxf(acc, log_floor));
    }
    __syncthreads();

    // DCT-II (or the log-mels as they are), rows written contiguously
    for (int p = tid; p < MWD_MFCC_TF * n_out; p += blockDim.x) {
        const int f = p / n_out;
        const int c = p - f * n_out;
        const long long m = tile0 + f;
        if (m >= m_total) break;  // p only grows, so every later m is out too
        const float* lm = mel_sh + f * (n_mels + 1);
        float v;
        if (dct != nullptr) {
            const float* d = dct + (long long)c * n_mels;
            v = 0.f;
            for (int i = 0; i < n_mels; ++i) v = fmaf(d[i], lm[i], v);
        } else {
            v = lm[c];
        }
        out[m * n_out + c] = v;
    }
}

extern "C" int mwd_mfcc(const float* sig, const float* tw, const float* window,
                        const float* fb, const int* fb_range, const float* dct, float* out,
                        int n_rows, int frames_per_row, int row_stride, int frame_stride,
                        int win, int n_fft, int n_mels, int n_out, int do_dct,
                        float log_floor, void* stream) {
    if (n_fft < 32 || n_fft > MWD_MFCC_MAX_NFFT || (n_fft & (n_fft - 1)) != 0 || win < 1
        || win > n_fft || n_mels < 1 || n_mels > MWD_MFCC_MAX_MELS || n_out < 1
        || n_out > n_mels || n_rows < 0 || frames_per_row < 0 || row_stride < 0
        || frame_stride < 0)
        return (int)cudaErrorInvalidValue;
    const long long m_total = (long long)n_rows * frames_per_row;
    if (m_total == 0) return (int)cudaGetLastError();
    const size_t smem = mwd_mfcc_smem(win, n_fft, n_mels);
    const int st = mwd_smem_optin(mwd_mfcc_kernel, smem);
    if (st != 0) return st;
    const long long blocks = (m_total + MWD_MFCC_TF - 1) / MWD_MFCC_TF;
    mwd_mfcc_kernel<<<(unsigned)blocks, MWD_MFCC_THREADS, smem, (cudaStream_t)stream>>>(
        sig, (const float2*)tw, window, fb, fb_range, do_dct ? dct : nullptr, out, m_total,
        frames_per_row, row_stride, frame_stride, win, n_fft, n_mels, n_out, log_floor);
    return (int)cudaGetLastError();
}
