// K3: Viterbi decode over factored transitions -> state path [N, Ts].
//
// Replaces multimodalworddiscovery_tpu/ops/viterbi_pallas.py: viterbi_pallas
// (_vit_fwd_kernel, then _vit_bwd_kernel).  Transitions are factored as in
// the E-step, trans[n, s, s'] = base[s, s'] - rowz[n, s] + colmask[n, s'],
// and the recursion is
//   delta'[s'] = max_s(delta[s] - rowz[s] + base[s, s']) + colmask[s'] + emit[t, s'],
// frozen past the utterance's length, then a backtrace from the argmax of
// the last delta.
//
// What bounds it on the H100: like the E-step, a sequential recursion with
// S <= 160 states per step, bound by latency (one barrier and an S-term
// max chain per step).  The TPU kernel streamed f32 deltas to HBM and
// recomputed every winning predecessor in the backtrace, to keep a
// backpointer tensor out of HBM.  Here one block decodes one utterance, one
// thread per state, with base in shared memory (row stride S + 1, free of
// bank conflicts down a column) and uint8 backpointers (S <= 255) in shared
// memory too whenever Ts * S bytes fit beside it (25.7 KB at Ts = 401,
// S = 64), so neither deltas nor backpointers touch device memory; longer
// utterances keep the backpointers in a global scratch the wrapper
// allocates.  One thread walks the backtrace.  Each step's sums are taken
// in the plain decoder's order ((delta - rowz) + base, then + colmask, then
// + emit) and ties go to the lowest state index, as in torch.max, so the
// path equals the plain decoder's.

#include <stdint.h>

#include "common.cuh"

// Shared memory besides the backpointers: base [S, S + 1], the shifted
// deltas [S] and the argmax scratch (32 floats + 32 ints), in floats.
static size_t mwd_vit_fixed_smem(int s) {
    return (size_t)(s * (s + 1) + s + 64) * sizeof(float);
}

static size_t mwd_vit_bp_bytes(int ts, int s) {
    return (((size_t)ts * s) + 15) / 16 * 16;
}

__global__ void mwd_viterbi_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ init,     // [N, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const int* __restrict__ lens,       // [N]
    int* __restrict__ path,             // out [N, Ts]
    uint8_t* __restrict__ bp_global,    // [N, Ts, S] scratch, or null: shared
    int ts, int s) {
    extern __shared__ float smem[];
    float* base_sh = smem;                 // [S, S + 1]
    float* d_sh = base_sh + s * (s + 1);   // [S]
    float* red_v = d_sh + s;               // [32]
    int* red_i = (int*)(red_v + 32);       // [32]
    const int n = blockIdx.x;
    const int j = threadIdx.x;
    const bool act = j < s;
    const int sp = s + 1;
    uint8_t* bp = bp_global ? bp_global + (long long)n * ts * s
                            : (uint8_t*)(red_i + 32);  // [Ts, S]
    for (int i = j; i < s * s; i += blockDim.x) base_sh[(i / s) * sp + (i % s)] = base[i];
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    const int len = lens[n];
    const float rz = act ? rowz[row + j] : 0.f;
    const float cm = act ? colmask[row + j] : 0.f;
    float delta = act ? init[row + j] + em[j] : -INFINITY;
    __syncthreads();
    for (int t = 1; t < ts; ++t) {
        if (act) d_sh[j] = delta - rz;
        __syncthreads();
        if (act) {
            float best = d_sh[0] + base_sh[j];
            int arg = 0;
            for (int k = 1; k < s; ++k) {
                const float v = d_sh[k] + base_sh[k * sp + j];
                if (v > best) {
                    best = v;
                    arg = k;
                }
            }
            const bool alive = t < len;
            if (alive) delta = best + cm + em[(long long)t * s + j];
            bp[(long long)t * s + j] = (uint8_t)(alive ? arg : j);
        }
        __syncthreads();
    }
    const int last = mwd_block_argmax(act ? delta : -INFINITY, act ? j : 0x7fffffff,
                                      red_v, red_i);
    __syncthreads();  // every backpointer row is written
    if (j == 0) {
        int* out = path + (long long)n * ts;
        int state = last;
        out[ts - 1] = state;
        for (int t = ts - 1; t >= 1; --t) {
            state = bp[(long long)t * s + state];
            out[t - 1] = state;
        }
    }
}

// 1 when the backpointers of a (Ts, S) decode fit in shared memory, else 0
// (the wrapper then passes a [N, Ts, S] uint8 scratch).
extern "C" int mwd_viterbi_bp_in_smem(int ts, int s) {
    return mwd_vit_fixed_smem(s) + mwd_vit_bp_bytes(ts, s) <= MWD_SMEM_OPTIN_MAX;
}

extern "C" int mwd_viterbi(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           int* path, uint8_t* bp_scratch, int n, int ts, int s,
                           void* stream) {
    if (s < 1 || s > MWD_MAX_S_GENERAL || ts < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    size_t smem = mwd_vit_fixed_smem(s);
    if (bp_scratch == nullptr) {
        if (!mwd_viterbi_bp_in_smem(ts, s)) return (int)cudaErrorInvalidValue;
        smem += mwd_vit_bp_bytes(ts, s);
    }
    const int st = mwd_smem_optin(mwd_viterbi_kernel, smem);
    if (st != 0) return st;
    mwd_viterbi_kernel<<<n, mwd_state_threads(s), smem, (cudaStream_t)stream>>>(
        base, init, rowz, colmask, emit, lens, path, bp_scratch, ts, s);
    return (int)cudaGetLastError();
}
