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
// an S-term max chain per step, bound by latency (two barriers and the
// chain per step).  The TPU kernel streamed f32 deltas to HBM and
// recomputed every winning predecessor in the backtrace, to keep a
// backpointer tensor out of HBM.  Here one block decodes one utterance,
// each thread a state (threads loop over the states when S > 1024; up to
// S = 65536, what 16-bit backpointers hold: base alone is 17 GB there), with
// base in shared memory (row stride S + 1, free of bank conflicts down a
// column) where it fits, else read from device memory, where it stays
// L2-resident (S above about 239).  Backpointers are uint8 up to S = 256
// and uint16 above, in shared memory too whenever Ts * S of them fit beside
// the rest (25.7 KB at Ts = 401, S = 64), so neither deltas nor
// backpointers touch device memory; longer utterances keep the backpointers
// in a global scratch the wrapper allocates.  One thread walks the
// backtrace.  Each step's sums are taken in the plain decoder's order
// ((delta - rowz) + base, then + colmask, then + emit) and ties go to the
// lowest state index, as in torch.max, so the path equals the plain
// decoder's.

#include <stdint.h>

#include "common.cuh"

// Backpointer bytes: uint8 holds the states of S <= 256, uint16 the rest.
static int mwd_vit_bp_size(int s) { return s <= 256 ? 1 : 2; }

// Shared memory besides the backpointers: base [S, S + 1] (when it fits),
// the deltas, the shifted deltas, rowz and colmask [S] each, and the argmax
// scratch (32 floats + 32 ints), in bytes.
static size_t mwd_vit_fixed_smem(int s, bool base_sm) {
    return ((size_t)(base_sm ? s * (s + 1) : 0) + 4 * (size_t)s + 64) * sizeof(float);
}

static bool mwd_vit_base_sm(int s) {
    return mwd_vit_fixed_smem(s, true) <= MWD_SMEM_OPTIN_MAX;
}

static size_t mwd_vit_bp_bytes(int ts, int s) {
    return ((size_t)ts * s * mwd_vit_bp_size(s) + 15) / 16 * 16;
}

// max_k (d[k] + base[k, j]) and its first argmax, base from shared memory
// (row stride S + 1) with BASE_SM, else from device memory.
template <bool BASE_SM>
__device__ __forceinline__ float mwd_vit_best(const float* d_sh, const float* base_sh,
                                              const float* __restrict__ base, int s, int j,
                                              int& arg) {
    auto b = [&](int k) { return BASE_SM ? base_sh[k * (s + 1) + j] : base[k * s + j]; };
    float best = d_sh[0] + b(0);
    arg = 0;
    // unrolled so that several of base's loads are in flight (device
    // memory's latency otherwise sets each step's time)
#pragma unroll 8
    for (int k = 1; k < s; ++k) {
        const float v = d_sh[k] + b(k);
        if (v > best) {
            best = v;
            arg = k;
        }
    }
    return best;
}

// ONE: one state a thread (S <= 1024), its delta, rowz and colmask in
// registers; else each thread loops over states j = tid + i * blockDim and
// keeps them in shared memory.  The looped form alone would serve every S,
// but with the deltas in shared memory it took 11-24% longer at S = 12, 64
// and 128 on an H100 (scripts/bench_estep.py), so S <= 1024 keeps ONE.
template <typename BP, bool BASE_SM, bool ONE>
__global__ void mwd_viterbi_kernel(
    const float* __restrict__ base,     // [S, S]
    const float* __restrict__ init,     // [N, S]
    const float* __restrict__ rowz,     // [N, S]
    const float* __restrict__ colmask,  // [N, S]
    const float* __restrict__ emit,     // [N, Ts, S]
    const int* __restrict__ lens,       // [N]
    int* __restrict__ path,             // out [N, Ts]
    BP* __restrict__ bp_global,         // [N, Ts, S] scratch, or null: shared
    int ts, int s) {
    extern __shared__ float smem[];
    float* base_sh = smem;                              // [S, S + 1] with BASE_SM
    float* dl = smem + (BASE_SM ? s * (s + 1) : 0);     // delta [S] (!ONE)
    float* d_sh = dl + s;                               // delta - rowz [S]
    float* rz = d_sh + s;                               // [S] (!ONE)
    float* cm = rz + s;                                 // [S] (!ONE)
    float* red_v = cm + s;                              // [32]
    int* red_i = (int*)(red_v + 32);                    // [32]
    const int n = blockIdx.x;
    const int nt = blockDim.x;
    BP* bp = bp_global ? bp_global + (long long)n * ts * s : (BP*)(red_i + 32);  // [Ts, S]
    if (BASE_SM)
        for (int i = threadIdx.x; i < s * s; i += nt)
            base_sh[(i / s) * (s + 1) + (i % s)] = base[i];
    const long long row = (long long)n * s;
    const float* em = emit + row * ts;
    const int len = lens[n];
    int last;
    if constexpr (ONE) {
        const int j = threadIdx.x;
        const bool act = j < s;
        const float rzj = act ? rowz[row + j] : 0.f;
        const float cmj = act ? colmask[row + j] : 0.f;
        float delta = act ? init[row + j] + em[j] : -INFINITY;
        __syncthreads();
        for (int t = 1; t < ts; ++t) {
            if (act) d_sh[j] = delta - rzj;
            __syncthreads();
            if (act) {
                int arg;
                const float best = mwd_vit_best<BASE_SM>(d_sh, base_sh, base, s, j, arg);
                const bool alive = t < len;
                if (alive) delta = best + cmj + em[(long long)t * s + j];
                bp[(long long)t * s + j] = (BP)(alive ? arg : j);
            }
            __syncthreads();
        }
        last = mwd_block_argmax(act ? delta : -INFINITY, act ? j : 0x7fffffff, red_v, red_i);
    } else {
        for (int j = threadIdx.x; j < s; j += nt) {
            rz[j] = rowz[row + j];
            cm[j] = colmask[row + j];
            dl[j] = init[row + j] + em[j];
        }
        __syncthreads();
        for (int t = 1; t < ts; ++t) {
            for (int j = threadIdx.x; j < s; j += nt) d_sh[j] = dl[j] - rz[j];
            __syncthreads();
            const bool alive = t < len;
            for (int j = threadIdx.x; j < s; j += nt) {
                int arg;
                const float best = mwd_vit_best<BASE_SM>(d_sh, base_sh, base, s, j, arg);
                if (alive) dl[j] = best + cm[j] + em[(long long)t * s + j];
                bp[(long long)t * s + j] = (BP)(alive ? arg : j);
            }
            __syncthreads();
        }
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        for (int j = threadIdx.x; j < s; j += nt) mwd_argmax_pick(bv, bi, dl[j], j);
        last = mwd_block_argmax(bv, bi, red_v, red_i);
    }
    __syncthreads();  // every backpointer row is written
    if (threadIdx.x == 0) {
        int* out = path + (long long)n * ts;
        int state = last;
        out[ts - 1] = state;
        for (int t = ts - 1; t >= 1; --t) {
            state = bp[(long long)t * s + state];
            out[t - 1] = state;
        }
    }
}

// Bytes of one backpointer (1 or 2) for S states.
extern "C" int mwd_viterbi_bp_size(int s) { return mwd_vit_bp_size(s); }

// 1 when the backpointers of a (Ts, S) decode fit in shared memory, else 0
// (the wrapper then passes a [N, Ts, S] scratch of mwd_viterbi_bp_size
// bytes an entry).
extern "C" int mwd_viterbi_bp_in_smem(int ts, int s) {
    return mwd_vit_fixed_smem(s, mwd_vit_base_sm(s)) + mwd_vit_bp_bytes(ts, s) <=
           MWD_SMEM_OPTIN_MAX;
}

extern "C" int mwd_viterbi(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           int* path, void* bp_scratch, int n, int ts, int s, void* stream) {
    if (s < 1 || ts < 1 || n < 0 || s > 65536) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const bool base_sm = mwd_vit_base_sm(s);
    size_t smem = mwd_vit_fixed_smem(s, base_sm);
    if (bp_scratch == nullptr) {
        if (!mwd_viterbi_bp_in_smem(ts, s)) return (int)cudaErrorInvalidValue;
        smem += mwd_vit_bp_bytes(ts, s);
    }
    const int threads = min(1024, mwd_state_threads(s));
    const bool one = s <= 1024;
#define MWD_VIT(BP, BSM, ONE)                                                                 \
    if (base_sm == BSM && one == ONE) {                                                       \
        const int st = mwd_smem_optin(mwd_viterbi_kernel<BP, BSM, ONE>, smem);                \
        if (st != 0) return st;                                                               \
        mwd_viterbi_kernel<BP, BSM, ONE><<<n, threads, smem, (cudaStream_t)stream>>>(          \
            base, init, rowz, colmask, emit, lens, path, (BP*)bp_scratch, ts, s);             \
        return (int)cudaGetLastError();                                                       \
    }
    if (mwd_vit_bp_size(s) == 1) {
        MWD_VIT(uint8_t, true, true)
        MWD_VIT(uint8_t, false, true)
    } else {
        MWD_VIT(uint16_t, true, true)
        MWD_VIT(uint16_t, false, true)
        MWD_VIT(uint16_t, false, false)
    }
#undef MWD_VIT
    return (int)cudaErrorInvalidValue;
}
