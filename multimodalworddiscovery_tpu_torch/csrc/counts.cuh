// The (phone, concept) count consumer shared by K2 (estep.cuh, the fused
// E-step's backward) and K7 (counts.cu, pair counts from gamma): a
// posterior gamma[n, t, j] goes to counts[src[n, t], conc[n, j]], into a
// [V_src, V_trg] table of the block in shared memory (zeroed at the start,
// its nonzero entries added into counts with one global atomic each at the
// end) or, where the table does not fit, straight into counts.
//
// The null states all emit concept 0 (hmm_core.state_concepts), so at one
// (n, t) their posteriors would all hit counts[src[n, t], 0].  A float
// atomic on one address from many lanes serialises, in shared memory as in
// L2, so the lanes of a row sum their null posteriors by shuffles first and
// one lane adds the sum (mwd_cnt_add_null).
#pragma once

#include "common.cuh"

struct MwdCnt {
    const int* src;   // [N, Ts] phone ids
    const int* conc;  // [N, S] concept id of each state
    float* counts;    // [v_src, v_trg], zeroed by the caller
    int v_src, v_trg, tab_sm;
};

__device__ __forceinline__ void mwd_cnt_add(const MwdCnt& c, float* tab, int ph, int cj, float v) {
    // ids are validated when the corpus is built; an id outside the table
    // already made K1's emission NaN
    if (ph < 0 || ph >= c.v_src || cj < 0 || cj >= c.v_trg) return;
    const int i = ph * c.v_trg + cj;
    if (c.tab_sm)
        atomicAdd(tab + i, v);
    else
        atomicAdd(c.counts + i, v);
}

// The null posteriors g0 of a row held by the `width` lanes of a segment:
// summed by shuffles (every lane of the warp calls this), then added once
// by the segment's leader.
__device__ __forceinline__ void mwd_cnt_add_null(const MwdCnt& c, float* tab, int ph, float g0,
                                                 bool leader, int width) {
    g0 = mwd_warp_sum(g0, width);
    if (leader && g0 != 0.f) mwd_cnt_add(c, tab, ph, 0, g0);
}

__device__ __forceinline__ void mwd_cnt_zero(const MwdCnt& c, float* tab) {
    for (int i = threadIdx.x; i < c.v_src * c.v_trg; i += blockDim.x) tab[i] = 0.f;
}

__device__ __forceinline__ void mwd_cnt_flush(const MwdCnt& c, const float* tab) {
    for (int i = threadIdx.x; i < c.v_src * c.v_trg; i += blockDim.x) {
        const float v = tab[i];
        if (v != 0.f) atomicAdd(c.counts + i, v);
    }
}
