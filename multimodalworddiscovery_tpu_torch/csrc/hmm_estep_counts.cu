// K2: the fused discrete-HMM E-step over factored transitions, on K4's
// design (estep.cuh), with the counts consumed in the backward.
//
// Replaces multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
// hmm_estep_counts_pallas (_fwd_kernel, then _bwd_counts_kernel with the
// step math of _bwd_math): a forward, then a backward that pools the
// transition posteriors xi [S, S] and adds each state posterior into the
// (phone, concept) emission counts [V_src, V_trg], so gamma never reaches
// device memory; and logZ [N].  S <= 64 (the fused route's gate,
// models/hmm.py FUSED_MAX_*; V_src <= 128 and V_trg <= 256 there).
//
// What bounds it on the H100: as K4, the sequential recursion's per-step
// chain (latency), not FLOPs or bytes.  K2 is K4's kernels with another
// consumer of the posteriors (see hmm_estep.cu's header): several
// utterances a warp (S <= 32, no barriers) or a block (S > 32, 4 or 8
// utterances over 256 threads, bf16 products on the tensor cores), in the
// length order of order.cuh with each warp or block stopping at its
// longest, xi summed per chunk of steps and reduced over blocks in a fixed
// order.  The float32 step product keeps the plain product's order, so the
// posteriors are K4's bit for bit.
//
// The counts consumer: at step t every state of utterance n shares the phone
// src[n, t], so state j's posterior goes to counts[src[n, t], conc[n, j]].  The
// backward adds it, in place of K4's gamma store, into a [V_src, V_trg] table
// of the block in shared memory (a shared-memory atomic; the phone is loaded a
// step ahead, off the chain), and once the block's sweep is done its nonzero
// entries go into the counts with one global atomic each.  Half of the states
// are null states, which all emit concept 0: their posteriors at a step would
// hit one entry from every lane, so a warp sums them by shuffles first and
// adds once.  The adds are integer adds in fixed point (counts.cuh: 64-bit
// numbers at a scale of 2^48, exact for posteriors from 2^-24 up), turned
// into float32 at the end of the call, so the counts come out the same in
// every run whatever order the blocks and warps add in.  Partial
// tables reduced in a fixed order would do that too, at the price of moving
// N / B x V_src x V_trg entries (26 MB at the VQ teacher's shape) through a
// second pass, and would still leave the order of the adds inside a block
// open.  The table takes 23.9 KB at the headline shape (49 x 61), 103 KB at
// the teacher's (64 x 201) and 256 KB at the gate's maximum (128 x 256).  On
// the block path it lives in shared memory beside the block's buffers where
// both fit with two blocks an SM (xi's chunk shrinks for it), else with one
// (the teacher's shape); on the warp path (128-thread blocks) where it takes
// at most MWD_K2_WARP_TAB bytes.  Elsewhere the posteriors go straight into
// the counts, two 64-bit atomics each: a layout choice, as K4's buffers in
// device memory are.
//
// One C call (mwd_estep_counts) runs the whole E-step: the counts' zeroing,
// the order and table, the forward, the backward with the counts, the
// counts' conversion to float32 and the xi reduction.  Its kernels carry
// their own names (mwd_estep_counts_*), so a profile tells K2's device time
// from K4's; only what K2 launches is instantiated (S <= 64: no remat, no
// buffers in device memory).

#include "estep.cuh"

#define MWD_K2_MAX_S 64
#define MWD_K2_WARP_TAB (32 * 1024)  // with xs (at most 16 KB) within the 48 KB default

__global__ void __launch_bounds__(MWD_ORDER_NT) mwd_estep_counts_prep(
    const float* __restrict__ base, const int* __restrict__ part, int n_utt, int s, int bf16,
    float* __restrict__ ws, int* __restrict__ perm) {
    mwd_prep_body(base, part, n_utt, s, bf16, ws, perm);
}

__global__ void mwd_estep_counts_finish(const unsigned long long* __restrict__ acc,
                                        float* __restrict__ counts, int cells) {
    mwd_cnt_to_float(acc, counts, cells);
}

__global__ void mwd_estep_counts_xi(const float* __restrict__ src, int rows, int cols,
                                    const float* __restrict__ mul, float* __restrict__ dst) {
    mwd_xi_reduce_body(src, rows, cols, mul, dst);
}

template <int SP, bool BF16>
__global__ void __launch_bounds__(MWD_WARPS * 32) mwd_estep_counts_fwd_warp(MWD_FWD_PARAMS) {
    mwd_fwd_warp_body<SP, BF16, false>(MWD_FWD_NAMES);
}

template <int SP, bool BF16>
__global__ void __launch_bounds__(MWD_WARPS * 32)
    mwd_estep_counts_bwd_warp(MWD_BWD_WARP_PARAMS, MwdCnt cnt) {
    mwd_bwd_warp_body<SP, BF16, false, true>(MWD_BWD_WARP_NAMES, cnt);
}

template <int B, bool BF16>
__global__ void __launch_bounds__(MWD_NT, 2)
    mwd_estep_counts_fwd_blk(MWD_FWD_PARAMS, int tab_sm, float* gbuf) {
    mwd_fwd_blk_body<B, BF16, false, false>(MWD_FWD_NAMES, tab_sm, gbuf);
}

// S <= 64: one 4 x 4 xi tile a thread (XT = 1)
template <int B, bool BF16>
__global__ void __launch_bounds__(MWD_NT, 2)
    mwd_estep_counts_bwd_blk(MWD_BWD_BLK_PARAMS, MwdCnt cnt) {
    mwd_bwd_blk_body<B, BF16, false, 1, false, true>(MWD_BWD_BLK_NAMES, cnt);
}

static bool mwd_k2_bad(int n, int ts, int s) {
    return n < 0 || ts < 1 || s < 1 || s > MWD_K2_MAX_S;
}

// Floats of mwd_estep_counts' workspace (K4's without the remat and
// device-memory parts), or -1 for a shape K2 does not take.
extern "C" long long mwd_estep_counts_work(int n, int ts, int s) {
    if (mwd_k2_bad(n, ts, s)) return -1;
    return mwd_work(n, ts, s, 0).total;
}

// K2 (bf16 = 0) or K2-bf16: counts [v_src, v_trg], xi [S, S] and logz [N]
// of the batch; work holds mwd_estep_counts_work(n, ts, s) floats and acc
// 2 x v_src x v_trg 64-bit integers (the counts in fixed point, zeroed here).
extern "C" int mwd_estep_counts(const float* base, const float* init, const float* rowz,
                                const float* colmask, const float* emit, const int* lens,
                                const int* src, const int* conc, float* work,
                                unsigned long long* acc, float* counts, float* xi, float* logz,
                                int n, int ts, int s, int v_src, int v_trg, int bf16,
                                void* stream) {
    if (mwd_k2_bad(n, ts, s) || v_src < 1 || v_trg < 1 || (long long)n * ts >= (1LL << 31) ||
        (long long)v_src * v_trg >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const MwdWork w = mwd_work(n, ts, s, 0);
    float* ws = work + w.ws;
    int* perm = reinterpret_cast<int*>(work + w.perm);
    float* alph = work + w.alph;
    float* xpart = work + w.xpart;
    const int cells = v_src * v_trg;
    int r = mwd_cnt_start(acc, cells, st);
    if (r == 0) r = mwd_estep_prepare(mwd_estep_counts_prep, base, lens, work, w, n, s, bf16, st);
    if (r != 0) return r;
    const int nb = mwd_n_blocks(n, s);
    MwdCnt cnt{src, conc, acc, v_src, v_trg, 0};
#define MWD_K2_FWD ws, init, rowz, colmask, emit, lens, perm, alph, logz, n, ts, s, 0
#define MWD_K2_BWD                                                                            \
    ws, init, rowz, colmask, emit, lens, perm, alph, logz, (float*)nullptr, xpart
    if (s <= 32) {
        const int th = MWD_WARPS * 32;
        const size_t tab = (size_t)cells * sizeof(unsigned long long);
        cnt.tab_sm = tab <= MWD_K2_WARP_TAB;
        const size_t smem = cnt.tab_sm ? tab : 0;
#define MWD_K2_WARP(SP, BF)                                                                   \
    if (mwd_sp(s) == SP && (bool)bf16 == BF) {                                                \
        r = mwd_go(mwd_estep_counts_fwd_warp<SP, BF>, nb, th, 0, stream, MWD_K2_FWD);          \
        if (r == 0)                                                                           \
            r = mwd_go(mwd_estep_counts_bwd_warp<SP, BF>, nb, th, smem, stream, MWD_K2_BWD, n, \
                       ts, s, 0, cnt);                                                        \
    }
        MWD_K2_WARP(8, false)
        MWD_K2_WARP(8, true)
        MWD_K2_WARP(16, false)
        MWD_K2_WARP(16, true)
        MWD_K2_WARP(32, false)
        MWD_K2_WARP(32, true)
#undef MWD_K2_WARP
    } else {
        const int b = mwd_blk_b(n, s);
        const MwdPlan pf = mwd_plan(s, false, false, b, bf16);
        const MwdPlan pb = mwd_plan_counts(s, b, bf16, cells);
        cnt.tab_sm = pb.cnt_sm;
#define MWD_K2_BLK(B, BF)                                                                     \
    if (b == B && (bool)bf16 == BF) {                                                         \
        r = mwd_go(mwd_estep_counts_fwd_blk<B, BF>, nb, MWD_NT, pf.bytes, stream, MWD_K2_FWD,  \
                   pf.tab_sm, (float*)nullptr);                                               \
        if (r == 0)                                                                           \
            r = mwd_go(mwd_estep_counts_bwd_blk<B, BF>, nb, MWD_NT, pb.bytes, stream,          \
                       MWD_K2_BWD, (float*)nullptr, n, ts, s, 0, pb.tc, pb.tab_sm,            \
                       (float*)nullptr, cnt);                                                 \
    }
        MWD_K2_BLK(MWD_B, false)
        MWD_K2_BLK(MWD_B, true)
        MWD_K2_BLK(8, false)
        MWD_K2_BLK(8, true)
#undef MWD_K2_BLK
    }
#undef MWD_K2_FWD
#undef MWD_K2_BWD
    if (r == 0) r = mwd_cnt_finish(mwd_estep_counts_finish, acc, counts, cells, st);
    if (r != 0) return r;
    return mwd_estep_xi(mwd_estep_counts_xi, work, w, n, s, xi, st);
}
