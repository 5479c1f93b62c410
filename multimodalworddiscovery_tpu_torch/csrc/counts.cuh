// The (phone, concept) count consumer shared by K2 (estep.cuh, the fused
// E-step's backward) and K7 (counts.cu, pair counts from gamma): a
// posterior gamma[n, t, j] goes to counts[src[n, t], conc[n, j]], into a
// [V_src, V_trg] table of the block in shared memory (zeroed at the start,
// its nonzero entries added into the counts at the end) or, where the
// table does not fit, straight into the counts.
//
// Every add is an integer add, so the counts do not depend on the order in
// which blocks and warps reach them: the same inputs give the same bits in
// every run.  Each posterior becomes a 64-bit fixed-point number at a scale
// of 2^48, exact for values from 2^-24 up (a float32 posterior has 24
// significant bits) and rounded to 2^-48 below; float32 sums keep about as
// many bits of a small count, and the M-step takes logs of counts down to
// its 1e-8 smoothing, so a coarser grid would show there.  The block table
// holds these 64-bit numbers.  An entry that reaches 2^62 is moved into the
// counts by the thread whose add took it there (an atomic exchange with 0,
// so every unit moves once); a value of 32 or more goes straight into the
// counts.  With at most 512 threads a block, each with one add below 2^53
// in flight, an entry stays below 2^63, whatever the values: posteriors,
// or any other nonnegative weights.  The counts (acc) are two 64-bit
// integers an entry, the high and the low 32 bits of the fixed point
// summed apart (units of 2^-16 and 2^-48), so they cannot overflow;
// mwd_cnt_finish turns them into float32 once, at the end.  A NaN or a
// negative value adds nothing (K2's NaN shows in its utterance's logZ).
//
// The null states all emit concept 0 (hmm_core.state_concepts), so at one
// (n, t) their posteriors would all hit counts[src[n, t], 0].  An atomic on
// one address from many lanes serialises, in shared memory as in L2, so the
// lanes of a row sum their null posteriors by shuffles first (a fixed
// butterfly order) and one lane adds the sum (mwd_cnt_add_null).
#pragma once

#include "common.cuh"

struct MwdCnt {
    const int* src;           // [N, Ts] phone ids
    const int* conc;          // [N, S] concept id of each state
    unsigned long long* acc;  // [2][v_src * v_trg]: high and low words, zeroed by the caller
    int v_src, v_trg, tab_sm;
};

// A fixed-point number q (units of 2^-48) into entry i of the counts.
__device__ __forceinline__ void mwd_cnt_acc(const MwdCnt& c, int i, unsigned long long q) {
    const unsigned long long hi = q >> 32, lo = q & 0xffffffffull;
    if (hi != 0ull) atomicAdd(c.acc + i, hi);
    if (lo != 0ull) atomicAdd(c.acc + c.v_src * c.v_trg + i, lo);
}

__device__ __forceinline__ void mwd_cnt_add(const MwdCnt& c, unsigned long long* tab, int ph,
                                            int cj, float v) {
    // ids are validated when the corpus is built; an id outside the table
    // already made K1's emission NaN
    if (ph < 0 || ph >= c.v_src || cj < 0 || cj >= c.v_trg) return;
    const int i = ph * c.v_trg + cj;
    if (v < 32.f) {
        const unsigned long long q = __float2ull_rn(v * 0x1p48f);
        if (q == 0ull) return;
        if (!c.tab_sm)
            mwd_cnt_acc(c, i, q);
        else if (atomicAdd(tab + i, q) + q >= (1ull << 62))
            mwd_cnt_acc(c, i, atomicExch(tab + i, 0ull));
    } else if (v > 0.f) {
        // the two words straight from the value, at any size
        const double d = (double)v * 0x1p16, hi = floor(d);
        if (hi != 0.0) atomicAdd(c.acc + i, (unsigned long long)hi);
        const unsigned long long lo = (unsigned long long)rint((d - hi) * 0x1p32);
        if (lo != 0ull) atomicAdd(c.acc + c.v_src * c.v_trg + i, lo);
    }
}

// The null posteriors g0 of a row held by the `width` lanes of a segment:
// summed by shuffles (every lane of the warp calls this), then added once
// by the segment's leader.
__device__ __forceinline__ void mwd_cnt_add_null(const MwdCnt& c, unsigned long long* tab, int ph,
                                                 float g0, bool leader, int width) {
    g0 = mwd_warp_sum(g0, width);
    if (leader && g0 != 0.f) mwd_cnt_add(c, tab, ph, 0, g0);
}

__device__ __forceinline__ void mwd_cnt_zero(const MwdCnt& c, unsigned long long* tab) {
    for (int i = threadIdx.x; i < c.v_src * c.v_trg; i += blockDim.x) tab[i] = 0ull;
}

__device__ __forceinline__ void mwd_cnt_flush(const MwdCnt& c, const unsigned long long* tab) {
    for (int i = threadIdx.x; i < c.v_src * c.v_trg; i += blockDim.x) {
        const unsigned long long v = tab[i];
        if (v != 0ull) mwd_cnt_acc(c, i, v);
    }
}

// The conversion's body; K2 and K7 wrap it in kernels of their own names
// (mwd_estep_counts_finish, mwd_pair_counts_finish), so a profile tells
// their device times apart.
__device__ __forceinline__ void mwd_cnt_to_float(const unsigned long long* __restrict__ acc,
                                                 float* __restrict__ counts, int cells) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < cells)
        counts[i] = (float)((double)acc[i] * 0x1p-16 + (double)acc[cells + i] * 0x1p-48);
}

// Zero the counts' two words before the adds.
static inline int mwd_cnt_start(unsigned long long* acc, int cells, cudaStream_t st) {
    return (int)cudaMemsetAsync(acc, 0, 2 * (size_t)cells * sizeof(unsigned long long), st);
}

// The counts in float32 by `finish` (a kernel on mwd_cnt_to_float), once
// every add is in.
template <typename Finish>
static int mwd_cnt_finish(Finish finish, const unsigned long long* acc, float* counts, int cells,
                          cudaStream_t st) {
    finish<<<(cells + 255) / 256, 256, 0, st>>>(acc, counts, cells);
    return (int)cudaGetLastError();
}
