// K4 and K6: the general HMM E-step over factored transitions, several
// utterances per block sharing one transition table.  The kernels' bodies
// are in estep.cuh, which K2 (hmm_estep_counts.cu) shares.
//
// K4 replaces multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
// hmm_estep_pallas (_fwd_kernel, then _bwd_kernel with _bwd_math): a forward
// sweep, then a backward sweep that writes the state posteriors gamma
// [N, Ts, S] and the pooled transition posteriors xi [S, S], and logZ [N].
// K6 is hmm_estep_pallas(remat=True) (_fwd_ckpt_kernel, _bwd_remat_kernel):
// the forward keeps only the alpha entering each chunk of tcr steps, and the
// backward recomputes each chunk's alphas before its steps.  K6 is a flag
// (CKPT, REMAT) of the same kernels, so it shares their layout and has no
// state limit either.
//
// Transitions come factored, trans[n, s, s'] = base[s, s'] - rowz[n, s] +
// colmask[n, s'], and each step's log-semiring product is an ordinary
// product on max-rescaled exponentials: the forward's p[s', b] = sum_s
// T[s, s'] e[s, b] and the backward's q[s, b] = sum_s' T[s, s'] f[s', b],
// T = exp(base0), base0 = max(base - max(base), NEG_INF).  T is the same for
// every utterance; only rowz and colmask differ.
//
// What bounds it on the H100: the recursion is sequential in time, and a
// step is small (S^2 multiply-adds an utterance), so latency bounds it: the
// per-step chain of barriers, reductions and dependent FMAs, not FLOPs or
// bytes.  The design puts several utterances into each block, so each step
// is a [S, S] x [S, B] product whose table is loaded once per block:
//
// - S <= 32 (the warp path): a warp holds 32 / SP utterances, SP = 8, 16 or
//   32 lanes each, one lane per state.  Each lane keeps its column of T (the
//   forward) and its row (the backward) in registers, reads the other
//   states' e or f by shuffles, and reduces the per-step maxima by xor
//   shuffles within its segment: no shared memory and no barrier in the
//   sweep.  Its share of xi, column j of sum_t ea f^T, sits in registers and
//   is added off the recursion's chain.
// - S > 32 (the block path): 256 threads and B = 4 utterances a block (8
//   where S <= 64 and the batch has at least 2048 utterances, so 8 warps
//   each finish one and a step's latency serves twice the work).  T
//   sits in shared memory with an odd row stride (conflict-free both down a
//   column and along a row) or, where it does not fit (S above about 200),
//   is read from the prepared copy in device memory, where it stays
//   L2-resident.  A step is two phases between two barriers: the product
//   into shared memory (float32: a thread per state and 4 utterances, one
//   FMA chain over the S terms, the plain version's order; bf16:
//   tensor-core tiles, their k range split KS ways so every warp has one),
//   then warp b alone finishes utterance b (sum of partials, log, emission,
//   the next step's maximum by shuffles and its exponentials).  Emission
//   rows (and the backward's alpha rows) come two steps ahead through
//   cp.async into a ring in shared memory, so their loads are off the chain.
// - Utterances are taken in length order (perm, longest first, ranked by
//   the preparation kernel; outputs stay in the caller's order), and each
//   block (each warp on the warp path) stops both sweeps at the longest of
//   its utterances: alphas past an utterance's length are never read, and
//   the backward writes gamma = 0 for t >= len, as the plain version does.
// - xi off the per-step chain (block path): each step's ea [B, S] and
//   f [B, S] go into a chunk buffer of TC steps in shared memory; once per
//   chunk the block adds ea^T f, an [S, TC * B] x [TC * B, S] product in 4 x 4
//   register tiles (16 x 8 tensor-core tiles in bf16), into its accumulator.
//   The accumulator lives in registers while it fits (S <= 128, at most 64
//   floats a thread), else in the block's slice of a [n_blocks, S, S]
//   scratch in device memory, read and written once per chunk.  Either
//   way each block writes its own [S, S] partial, and a small reduction
//   kernel sums the partials in a fixed order and multiplies by the float32
//   T once: xi is deterministic and no
//   shared memory is spent on it at large S.  The reference multiplies by T
//   at every step (hmm_fwdbwd_pallas.py:204); the two differ only in the
//   order of rounding.
//
// dot_dtype="bfloat16" (BF16): the operands of the three products are
// rounded to bf16 (nearest even) and the products summed in float32, the
// reference's MXU semantics.  On the block path the three run on the tensor
// cores, mma.sync.m16n8k16 with bf16 operands and float32 accumulators: the
// step products with the table as A (its fragments kept in registers for
// the sweep where a warp's share fits, S <= 128) and the block's utterances
// as the instruction's n = 8 columns, and xi's chunk product with ea^T as A
// and f as B while its accumulator is in registers.  The warp path rounds
// the same operands and multiplies on FMAs (a bf16 x bf16 product is exact
// in float32).  The products read a table rounded once, as it is prepared;
// xi's final multiply uses the float32 table, as the reference's bexp32 *
// xc does.  wgmma is not used: its 64-row tiles are larger than a step's
// product.  Float32 stays IEEE float32 on FMAs throughout (no TF32).
//
// The masking is the reference's: frozen carries past src_len, logZ = 0
// for an empty utterance, the rowz guard (rowz is 0 on fully masked rows,
// from the caller), the m > NEG_INF / 2 guards, the ea clamp at 80, and
// gamma = exp(min(lg, 0)).
//
// Shared memory: the table takes S * (S | 1) floats; the rest scales as
// S * B (the phases' buffers and rings) and TC * B * S (xi's chunk), with
// TC chosen at launch from what is left (16 down to 1).  Where even one
// chunk step of B utterances does not fit in a block's 227 KB (S above
// about 1100 in the backward, 1800 in the forward), the block's buffers
// move to its own slice of the workspace in device memory (gbuf; plain
// loads and stores take cp.async's place), so the kernels have no state
// limit of their own.  What a call needs in device memory then grows with
// the xi partials, N / B * S^2 floats, beside gamma's N * Ts * S.

#include "estep.cuh"

__global__ void __launch_bounds__(MWD_ORDER_NT) mwd_estep_prep(
    const float* __restrict__ base, const int* __restrict__ part, int n_utt, int s, int bf16,
    float* __restrict__ ws, int* __restrict__ perm) {
    mwd_prep_body(base, part, n_utt, s, bf16, ws, perm);
}

__global__ void mwd_estep_xi_reduce(const float* __restrict__ src, int rows, int cols,
                                    const float* __restrict__ mul, float* __restrict__ dst) {
    mwd_xi_reduce_body(src, rows, cols, mul, dst);
}

template <int SP, bool BF16, bool CKPT>
__global__ void __launch_bounds__(MWD_WARPS * 32) mwd_estep_fwd_warp(MWD_FWD_PARAMS) {
    mwd_fwd_warp_body<SP, BF16, CKPT>(MWD_FWD_NAMES);
}

template <int SP, bool BF16, bool REMAT>
__global__ void __launch_bounds__(MWD_WARPS * 32) mwd_estep_bwd_warp(MWD_BWD_WARP_PARAMS) {
    mwd_bwd_warp_body<SP, BF16, REMAT, false>(MWD_BWD_WARP_NAMES, MwdCnt{});
}

template <int B, bool BF16, bool CKPT, bool GLOB>
__global__ void __launch_bounds__(MWD_NT, 2) mwd_estep_fwd_blk(MWD_FWD_PARAMS, int tab_sm,
                                                              float* gbuf) {
    mwd_fwd_blk_body<B, BF16, CKPT, GLOB>(MWD_FWD_NAMES, tab_sm, gbuf);
}

template <int B, bool BF16, bool REMAT, int XT, bool GLOB>
__global__ void __launch_bounds__(MWD_NT, XT == MWD_XREG_TILES ? 1 : 2)
    mwd_estep_bwd_blk(MWD_BWD_BLK_PARAMS) {
    mwd_bwd_blk_body<B, BF16, REMAT, XT, GLOB, false>(MWD_BWD_BLK_NAMES, MwdCnt{});
}

static bool mwd_estep_bad(int n, int ts, int s, int tcr) {
    return s < 1 || ts < 1 || n < 0 || tcr < 0;
}

// Floats of mwd_estep's workspace, or -1 for a shape no E-step has.
extern "C" long long mwd_estep_work(int n, int ts, int s, int tcr) {
    if (mwd_estep_bad(n, ts, s, tcr)) return -1;
    return mwd_work(n, ts, s, tcr).total;
}

static int mwd_estep_fwd(const float* ws, const float* init, const float* rowz,
                         const float* colmask, const float* emit, const int* lens,
                         const int* perm, float* out, float* logz, int n, int ts, int s, int tcr,
                         int bf16, float* gbuf, void* stream) {
    const int nb = mwd_n_blocks(n, s);
#define MWD_FWD_ARGS ws, init, rowz, colmask, emit, lens, perm, out, logz, n, ts, s, tcr
    if (s <= 32) {
        const int th = MWD_WARPS * 32;
#define MWD_FWD_WARP(SP)                                                                      \
    if (mwd_sp(s) == SP) {                                                                    \
        if (bf16)                                                                             \
            return tcr ? mwd_go(mwd_estep_fwd_warp<SP, true, true>, nb, th, 0, stream,        \
                                MWD_FWD_ARGS)                                                 \
                       : mwd_go(mwd_estep_fwd_warp<SP, true, false>, nb, th, 0, stream,       \
                                MWD_FWD_ARGS);                                                \
        return tcr ? mwd_go(mwd_estep_fwd_warp<SP, false, true>, nb, th, 0, stream,           \
                            MWD_FWD_ARGS)                                                     \
                   : mwd_go(mwd_estep_fwd_warp<SP, false, false>, nb, th, 0, stream,          \
                            MWD_FWD_ARGS);                                                    \
    }
        MWD_FWD_WARP(8)
        MWD_FWD_WARP(16)
        MWD_FWD_WARP(32)
#undef MWD_FWD_WARP
    }
    const int b = mwd_blk_b(n, s);
    const MwdPlan pl = mwd_plan(s, false, false, b, bf16);
#define MWD_FWD_BLK(B, GLOB, GB)                                                              \
    if (b == B && pl.glob == GLOB) {                                                          \
        if (bf16)                                                                             \
            return tcr ? mwd_go(mwd_estep_fwd_blk<B, true, true, GLOB>, nb, MWD_NT, pl.bytes, \
                                stream, MWD_FWD_ARGS, pl.tab_sm, GB)                          \
                       : mwd_go(mwd_estep_fwd_blk<B, true, false, GLOB>, nb, MWD_NT, pl.bytes, \
                                stream, MWD_FWD_ARGS, pl.tab_sm, GB);                         \
        return tcr ? mwd_go(mwd_estep_fwd_blk<B, false, true, GLOB>, nb, MWD_NT, pl.bytes,    \
                            stream, MWD_FWD_ARGS, pl.tab_sm, GB)                              \
                   : mwd_go(mwd_estep_fwd_blk<B, false, false, GLOB>, nb, MWD_NT, pl.bytes,   \
                            stream, MWD_FWD_ARGS, pl.tab_sm, GB);                             \
    }
    // S <= 64 (8 utterances a block) always fits in shared memory
    MWD_FWD_BLK(8, false, (float*)nullptr)
    MWD_FWD_BLK(MWD_B, false, (float*)nullptr)
    MWD_FWD_BLK(MWD_B, true, gbuf)
#undef MWD_FWD_BLK
#undef MWD_FWD_ARGS
    return (int)cudaErrorInvalidValue;
}

template <int B, bool BF16, bool REMAT>
static int mwd_estep_bwd_blk_go(int xt, int nb, const MwdPlan& pl, float* gbuf, void* stream,
                                const float* ws, const float* init, const float* rowz,
                                const float* colmask, const float* emit, const int* lens,
                                const int* perm, const float* alph, const float* logz,
                                float* gamma, float* xpart, float* achunk, int n, int ts, int s,
                                int tcr) {
#define MWD_BWD_BLK(XT, GLOB, GB)                                                             \
    return mwd_go(mwd_estep_bwd_blk<B, BF16, REMAT, XT, GLOB>, nb, MWD_NT, pl.bytes, stream,  \
                  ws, init, rowz, colmask, emit, lens, perm, alph, logz, gamma, xpart, achunk, n, \
                  ts, s, tcr, pl.tc, pl.tab_sm, GB)
    if constexpr (B == 8) {  // S <= 64: one 4 x 4 tile a thread, in shared memory
        MWD_BWD_BLK(1, false, (float*)nullptr);
    } else {
        // the buffers go to device memory only far above S = 128 (xi's
        // accumulator is there too)
        if (pl.glob) MWD_BWD_BLK(0, true, gbuf);
        if (xt == 1) MWD_BWD_BLK(1, false, (float*)nullptr);
        if (xt == MWD_XREG_TILES) MWD_BWD_BLK(MWD_XREG_TILES, false, (float*)nullptr);
        MWD_BWD_BLK(0, false, (float*)nullptr);
    }
#undef MWD_BWD_BLK
}

static int mwd_estep_bwd(const float* ws, const float* init, const float* rowz,
                         const float* colmask, const float* emit, const int* lens,
                         const int* perm, const float* alph, const float* logz, float* gamma,
                         float* xpart, float* achunk, int n, int ts, int s, int tcr, int bf16,
                         float* gbuf, void* stream) {
    const int nb = mwd_n_blocks(n, s);
#define MWD_BWD_ARGS ws, init, rowz, colmask, emit, lens, perm, alph, logz, gamma, xpart
    if (s <= 32) {
        const int th = MWD_WARPS * 32;
#define MWD_BWD_WARP(SP)                                                                      \
    if (mwd_sp(s) == SP) {                                                                    \
        if (bf16)                                                                             \
            return tcr ? mwd_go(mwd_estep_bwd_warp<SP, true, true>, nb, th, 0, stream,        \
                                MWD_BWD_ARGS, n, ts, s, tcr)                                  \
                       : mwd_go(mwd_estep_bwd_warp<SP, true, false>, nb, th, 0, stream,       \
                                MWD_BWD_ARGS, n, ts, s, tcr);                                 \
        return tcr ? mwd_go(mwd_estep_bwd_warp<SP, false, true>, nb, th, 0, stream,           \
                            MWD_BWD_ARGS, n, ts, s, tcr)                                      \
                   : mwd_go(mwd_estep_bwd_warp<SP, false, false>, nb, th, 0, stream,          \
                            MWD_BWD_ARGS, n, ts, s, tcr);                                     \
    }
        MWD_BWD_WARP(8)
        MWD_BWD_WARP(16)
        MWD_BWD_WARP(32)
#undef MWD_BWD_WARP
    }
    const int b = mwd_blk_b(n, s);
    const MwdPlan pl = mwd_plan(s, true, tcr > 0, b, bf16);
    // xi tiles a thread keeps in registers: as few as cover the 4 x 4 tiles
    // (float32) or, in bf16, a warp's 16 x 8 tensor-core tiles, four to XT
    const int tiles = (mwd_up4(s) / 4) * (mwd_up4(s) / 4);
    const int warp_tiles = ((s + 15) / 16 * ((s + 7) / 8) + MWD_NT / 32 - 1) / (MWD_NT / 32);
    const int need = bf16 ? (warp_tiles + 3) / 4 : (tiles + MWD_NT - 1) / MWD_NT;
    const int xt = need <= 1 ? 1 : need <= MWD_XREG_TILES ? MWD_XREG_TILES : 0;
#define MWD_BWD_GO(B, BF, RE) \
    return mwd_estep_bwd_blk_go<B, BF, RE>(xt, nb, pl, gbuf, stream, MWD_BWD_ARGS, achunk, n, ts, \
                                           s, tcr)
    if (b == 8) {
        if (bf16) { if (tcr) MWD_BWD_GO(8, true, true); MWD_BWD_GO(8, true, false); }
        if (tcr) MWD_BWD_GO(8, false, true);
        MWD_BWD_GO(8, false, false);
    }
    if (bf16) { if (tcr) MWD_BWD_GO(MWD_B, true, true); MWD_BWD_GO(MWD_B, true, false); }
    if (tcr) MWD_BWD_GO(MWD_B, false, true);
    MWD_BWD_GO(MWD_B, false, false);
#undef MWD_BWD_GO
#undef MWD_BWD_ARGS
}

// K4 (tcr = 0) or K6 (tcr > 0, its chunk): the preparation (length order
// and tables), the forward (alphas, or K6's checkpoints, and logZ), the
// backward (gamma and the blocks' xi partials), then xi = T * (the sum of
// the partials).  work holds mwd_estep_work(n, ts, s, tcr) floats; bf16 != 0
// selects the bf16 variant.
extern "C" int mwd_estep(const float* base, const float* init, const float* rowz,
                         const float* colmask, const float* emit, const int* lens, float* work,
                         float* gamma, float* xi, float* logz, int n, int ts, int s, int tcr,
                         int bf16, void* stream) {
    if (mwd_estep_bad(n, ts, s, tcr)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const MwdWork w = mwd_work(n, ts, s, tcr);
    float* ws = work + w.ws;
    int* perm = reinterpret_cast<int*>(work + w.perm);
    float* alph = work + w.alph;
    float* xpart = work + w.xpart;
    const cudaStream_t st = (cudaStream_t)stream;
    int r = mwd_estep_prepare(mwd_estep_prep, base, lens, work, w, n, s, bf16, st);
    if (r == 0) r = mwd_estep_fwd(ws, init, rowz, colmask, emit, lens, perm, alph, logz, n, ts, s,
                                  tcr, bf16, work + w.gbuf, stream);
    if (r == 0) r = mwd_estep_bwd(ws, init, rowz, colmask, emit, lens, perm, alph, logz, gamma,
                                  xpart, work + w.achunk, n, ts, s, tcr, bf16, work + w.gbuf,
                                  stream);
    if (r != 0) return r;
    return mwd_estep_xi(mwd_estep_xi_reduce, work, w, n, s, xi, st);
}
