// K3: Viterbi decode over factored transitions -> state path [N, Ts],
// several utterances a warp or a block.
//
// Replaces multimodalworddiscovery_tpu/ops/viterbi_pallas.py: viterbi_pallas
// (_vit_fwd_kernel, then _vit_bwd_kernel).  Transitions are factored as in
// the E-step, trans[n, s, s'] = base[s, s'] - rowz[n, s] + colmask[n, s'],
// and the recursion is
//   delta'[s'] = max_s(delta[s] - rowz[s] + base[s, s']) + colmask[s'] + emit[t, s'],
// frozen past the utterance's length, then a backtrace from the argmax of
// the last delta.
//
// What bounds it on the H100: a sequential recursion whose step is an
// S x S max-plus product with an argmax, so latency and the issue of
// shared-memory loads, not bytes: one block per utterance (the first
// design) made two shared loads per term and left short chains of few
// warps.  The TPU kernel streamed f32 deltas to HBM and recomputed every
// winning predecessor in the backtrace; here the backpointers are kept.
// The design shares K4's (hmm_estep.cu):
//
// - Utterances in length order (order.cuh, the one ranking of K2, K3 and
//   K4), longest first; each warp or block stops its sweep at its longest
//   utterance.  Past an utterance's length its delta is frozen and its
//   backpointers are the identity, so none are stored or read there: the
//   path from len - 1 on is the argmax of the frozen delta, and a
//   zero-length utterance's whole path is the argmax of init + emit[0],
//   as the plain decoder's.
// - S <= 32 (the warp path): 32 / SP utterances a warp, SP = 8, 16 or 32
//   lanes each, one lane a state; each lane keeps its column of base in
//   registers and reads the other states' delta - rowz by shuffles: no
//   shared memory and no barrier in the sweep.
// - S > 32 (the block path): B = 4 utterances a block (8 where S <= 64 and
//   the batch has at least 2048; 1 where blocks of 4 would not give half
//   the SMs a block), 256 threads up to S = 128 and 1024 above, each thread
//   one state for all B: one load of base serves B max-plus terms, and the
//   B shifted deltas of a state sit side by side in shared memory ([S][B],
//   one or two 16-byte loads).  Where threads are to spare a state's k
//   range is split into KS <= 4 independent chains (contiguous ranges, so a
//   warp's loads of base stay on one row) whose (max, first argmax) pairs
//   are combined in chain order: the larger value wins and on equal values
//   the lower index, which is exactly the sequential strict-> scan and
//   torch.max.  Base sits in shared memory where it fits beside the buffers
//   (else it is read from device memory, where it stays L2-resident),
//   emission rows arrive a step ahead through cp.async, and the deltas are
//   double-buffered, so a step has one barrier (two with split chains:
//   interleaving k over a warp's lanes and combining by shuffles, one
//   barrier a step, measured slower on the H100, 2.37 against 1.83 ms at
//   S = 64 and 6.57 against 1.85 at S = 260, where base is read from device
//   memory).  Where not even the buffers fit (S above about 2000) they move
//   to the block's slice of a workspace in device memory.
// - Backpointers: uint8 up to S = 256 states, uint16 above (S <= 65536),
//   in shared memory where [utterances of the block, Ts, S] of them fit
//   (two blocks an SM where the batch needs more than one wave), else in a
//   [N, Ts, S] workspace in device memory.  One thread per utterance walks
//   the backtrace, from shared memory: backpointers in device memory are
//   first copied by the utterance's warp, up to 64 rows at a time, into the
//   freed buffers, so the walk's dependent loads are not device-memory
//   round trips.
//
// Each step's sums are taken in the plain decoder's order ((delta - rowz)
// + base, then + colmask, then + emit), so the path equals the plain
// decoder's.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "order.cuh"

#define MWD_VIT_NT 256               // threads of a block-path block up to S = 128
#define MWD_VIT_NT_BIG 1024          // and above
#define MWD_VIT_WARPS 4              // warps of a warp-path block
#define MWD_VIT_B8_MIN 2048          // batch from which S <= 64 blocks take 8 utterances
#define MWD_VIT_KS_MAX 4             // most chains a state's max is split into
#define MWD_VIT_WARP_BP (48 * 1024)  // most backpointer bytes of a warp-path block in shared memory

static int mwd_vit_sp(int s) { return s <= 8 ? 8 : s <= 16 ? 16 : 32; }
static int mwd_vit_bp_size(int s) { return s <= 256 ? 1 : 2; }

// The length order's scatter (order.cuh) under K3's name.
__global__ void __launch_bounds__(MWD_ORDER_NT) mwd_viterbi_order(const int* __restrict__ part,
                                                                 int n_utt, int* __restrict__ perm) {
    mwd_length_scatter(part, n_utt, perm);
}

// ---------------------------------------------------------------------------
// The warp path (S <= 32).  bpg: [N, Ts, S] backpointers in device memory,
// or null: the block's in dynamic shared memory, [slot, Ts, S].
// ---------------------------------------------------------------------------
template <int SP>
__global__ void __launch_bounds__(MWD_VIT_WARPS * 32) mwd_viterbi_warp(
    const float* __restrict__ base, const float* __restrict__ init,
    const float* __restrict__ rowz, const float* __restrict__ colmask,
    const float* __restrict__ emit, const int* __restrict__ lens, const int* __restrict__ perm,
    int* __restrict__ path, uint8_t* bpg, int n_utt, int ts, int s) {
    extern __shared__ float4 vsm4[];
    const int lane = threadIdx.x & 31, j = lane % SP;
    const int slot = (threadIdx.x >> 5) * (32 / SP) + lane / SP;
    const int u = blockIdx.x * (MWD_VIT_WARPS * (32 / SP)) + slot;
    const int n = u < n_utt ? perm[u] : -1;
    const int len = n >= 0 ? lens[n] : 0;
    int tmax = len;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tmax = max(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const bool act = j < s && n >= 0;
    float bcol[SP];  // column j of base
#pragma unroll
    for (int k = 0; k < SP; ++k) bcol[k] = (j < s && k < s) ? base[k * s + j] : 0.f;
    const long long row = (long long)max(n, 0) * s;
    const float* em = emit + row * ts;
    const float rz = act ? rowz[row + j] : 0.f;
    const float cm = act ? colmask[row + j] : 0.f;
    uint8_t* bp = bpg ? bpg + row * ts
                      : reinterpret_cast<uint8_t*>(vsm4) + (long long)slot * ts * s;
    float delta = act ? init[row + j] + em[j] : -INFINITY;
    float em_next = (act && tmax > 1) ? em[s + j] : 0.f;
    for (int t = 1; t < tmax; ++t) {
        const float em_t = em_next;
        if (act && t + 1 < tmax) em_next = em[(long long)(t + 1) * s + j];
        const float d = act ? delta - rz : -INFINITY;
        float best = __shfl_sync(0xffffffffu, d, 0, SP) + bcol[0];
        int arg = 0;
#pragma unroll
        for (int k = 1; k < SP; ++k) {
            const float v = __shfl_sync(0xffffffffu, d, k, SP) + bcol[k];
            if (k < s && v > best) {
                best = v;
                arg = k;
            }
        }
        if (act && t < len) {
            delta = best + cm + em_t;
            bp[(long long)t * s + j] = (uint8_t)arg;
        }
    }
    // the segment's argmax of the last delta (lowest state on a tie)
    float v = act ? delta : -INFINITY;
    int last = act ? j : 0x7fffffff;
#pragma unroll
    for (int o = SP / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, last, o);
        mwd_argmax_pick(v, last, ov, oi);
    }
    __syncwarp();  // the segment's backpointers are written
    if (n < 0) return;
    int* out = path + (long long)n * ts;
    for (int t = max(len - 1, 0) + j; t < ts; t += SP) out[t] = last;
    if (j == 0) {
        int state = last;
        for (int t = len - 1; t >= 1; --t) {
            state = bp[(long long)t * s + state];
            out[t - 1] = state;
        }
    }
}

// ---------------------------------------------------------------------------
// The block path (S > 32).
// ---------------------------------------------------------------------------

// The block's buffers, in floats (each region a multiple of 4), then its
// backpointers where they are in shared memory.
struct MwdVitLayout {
    int bs, d, dl, rz, cm, emr, pv, pi, un, tab, floats;
    size_t bp, bytes;  // byte offset of the backpointers, total bytes in shared memory
};

__host__ __device__ inline MwdVitLayout mwd_vit_layout(int s, int ts, int b, int ks, bool tab_sm,
                                                       bool bp_sm, bool glob) {
    MwdVitLayout L;
    const int bs = (b * s + 3) & ~3;  // a [B][S] region, rounded up to 4 floats
    L.bs = bs;
    int o = 0;
    L.d = o;   o += 2 * bs;                  // delta - rowz, double-buffered [2][S][B]
    L.dl = o;  o += bs;                      // delta [B][S]
    L.rz = o;  o += bs;                      // rowz [B][S]
    L.cm = o;  o += bs;                      // colmask [B][S]
    L.emr = o; o += 2 * bs;                  // emission rows t and t + 1, [2][B][S]
    L.pv = o;  o += ks > 1 ? ks * bs : 0;    // the chains' maxima [KS][B][S]
    L.pi = o;  o += ks > 1 ? ks * bs : 0;    // and argmaxes (int)
    L.un = o;  o += (2 * b + 3) & ~3;        // the utterances and their lengths (int)
    L.tab = o; o += tab_sm ? (s * s + 3) & ~3 : 0;  // base [S][S]
    L.floats = o;
    L.bp = glob ? 0 : (size_t)o * sizeof(float);
    L.bytes = L.bp + (bp_sm ? (size_t)b * ts * s * (s <= 256 ? 1 : 2) : 0);
    return L;
}

template <int B>
__device__ __forceinline__ void mwd_vit_load_d(const float* D, int k, float (&d)[B]) {
    if constexpr (B % 4 == 0) {
        const float4* p = reinterpret_cast<const float4*>(D + k * B);
#pragma unroll
        for (int q = 0; q < B / 4; ++q) {
            const float4 v = p[q];
            d[4 * q] = v.x;
            d[4 * q + 1] = v.y;
            d[4 * q + 2] = v.z;
            d[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int b = 0; b < B; ++b) d[b] = D[k * B + b];
    }
}

// B utterances a block; BP the backpointer type; GLOB: the buffers in the
// block's slice of gbuf.  ks chains a state; tab_sm: base in shared memory;
// bpg: [N, Ts, S] backpointers in device memory, or null: in shared memory.
template <int B, typename BP, bool GLOB>
__global__ void __launch_bounds__(MWD_VIT_NT_BIG) mwd_viterbi_blk(
    const float* __restrict__ base, const float* __restrict__ init,
    const float* __restrict__ rowz, const float* __restrict__ colmask,
    const float* __restrict__ emit, const int* __restrict__ lens, const int* __restrict__ perm,
    int* __restrict__ path, BP* bpg, int n_utt, int ts, int s, int ks, int tab_sm, float* gbuf) {
    extern __shared__ float4 vsm4[];
    const MwdVitLayout L = mwd_vit_layout(s, ts, B, ks, tab_sm, bpg == nullptr, GLOB);
    float* sm;
    if constexpr (GLOB)
        sm = gbuf + (long long)blockIdx.x * L.floats;
    else
        sm = reinterpret_cast<float*>(vsm4);
    float *D = sm + L.d, *DL = sm + L.dl, *RZ = sm + L.rz, *CM = sm + L.cm, *EMR = sm + L.emr;
    float* PV = sm + L.pv;
    int* PI = reinterpret_cast<int*>(sm + L.pi);
    int* UN = reinterpret_cast<int*>(sm + L.un);  // [B] utterances, then [B] lengths
    BP* bps = reinterpret_cast<BP*>(reinterpret_cast<char*>(vsm4) + L.bp);
    // items (b, j) run over B * S; bs, that rounded up to 4, strides the
    // double buffers
    const int bs = L.bs, items = B * s, nt = blockDim.x;
    if (threadIdx.x < B) {
        const int u = blockIdx.x * B + threadIdx.x;
        const int n = u < n_utt ? perm[u] : -1;
        UN[threadIdx.x] = n;
        UN[B + threadIdx.x] = n >= 0 ? lens[n] : 0;
    }
    if (tab_sm)
        for (int i = threadIdx.x; i < s * s; i += nt) sm[L.tab + i] = base[i];
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += nt) {
        const int b = it / s, j = it - b * s, n = UN[b];
        const long long at = (long long)max(n, 0) * s + j;
        const float rz = n >= 0 ? rowz[at] : 0.f;
        const float dl = n >= 0 ? init[at] + emit[(long long)max(n, 0) * ts * s + j] : -INFINITY;
        RZ[it] = rz;
        CM[it] = n >= 0 ? colmask[at] : 0.f;
        DL[it] = dl;
        D[j * B + b] = dl - rz;
    }
    int tmax = 0;
#pragma unroll
    for (int b = 0; b < B; ++b) tmax = max(tmax, UN[B + b]);
    // emission row t of the block's utterances into slot t % 2
    auto prefetch = [&](int t) {
        if (t < tmax)
            for (int it = threadIdx.x; it < items; it += nt) {
                const int b = it / s, j = it - b * s, n = UN[b];
                if (n < 0) continue;
                float* dst = EMR + (t & 1) * bs + it;
                const float* src = emit + ((long long)n * ts + t) * s + j;
                if constexpr (GLOB) {
                    *dst = *src;
                } else {
                    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
                    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
                }
            }
        if constexpr (!GLOB) asm volatile("cp.async.commit_group;\n");
    };
    auto wait_rows = [&]() {
        if constexpr (!GLOB) asm volatile("cp.async.wait_all;\n");
    };
    auto bp_of = [&](int b) {
        return bpg ? bpg + (long long)max(UN[b], 0) * ts * s : bps + (long long)b * ts * s;
    };
    // the new delta of (b, j) at step t from its max and argmax
    auto finish = [&](int b, int j, float best, int arg, int t, float* Dn) {
        const int it = b * s + j;
        if (t < UN[B + b]) {
            DL[it] = best + CM[it] + EMR[(t & 1) * bs + it];
            bp_of(b)[(long long)t * s + j] = (BP)arg;
        }
        Dn[j * B + b] = DL[it] - RZ[it];
    };
    const int kc = (s + ks - 1) / ks;
    // phase 1: chain c of state j over k in [c kc, (c + 1) kc), all B
    // utterances at once; with one chain it finishes (b, j) itself
    auto chains = [&](auto tsm, int t, const float* Dc, float* Dn) {
        constexpr bool TSM = decltype(tsm)::value;
        auto bk = [&](int k, int j) {
            if constexpr (TSM) return sm[L.tab + k * s + j];
            return __ldg(base + (long long)k * s + j);
        };
        for (int it = threadIdx.x; it < s * ks; it += nt) {
            const int c = it / s, j = it - c * s;
            const int k0 = c * kc, k1 = min(s, k0 + kc);
            float best[B], d[B];
            int arg[B];
            mwd_vit_load_d<B>(Dc, k0, d);
            const float b0 = bk(k0, j);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                best[b] = d[b] + b0;
                arg[b] = k0;
            }
#pragma unroll 4
            for (int k = k0 + 1; k < k1; ++k) {
                const float bv = bk(k, j);
                mwd_vit_load_d<B>(Dc, k, d);
#pragma unroll
                for (int b = 0; b < B; ++b) {
                    const float v = d[b] + bv;
                    if (v > best[b]) {
                        best[b] = v;
                        arg[b] = k;
                    }
                }
            }
            if (ks > 1) {
#pragma unroll
                for (int b = 0; b < B; ++b) {
                    PV[(c * B + b) * s + j] = best[b];
                    PI[(c * B + b) * s + j] = arg[b];
                }
            } else {
#pragma unroll
                for (int b = 0; b < B; ++b) finish(b, j, best[b], arg[b], t, Dn);
            }
        }
    };
    prefetch(1);
    wait_rows();
    __syncthreads();
    for (int t = 1; t < tmax; ++t) {
        const float* Dc = D + ((t - 1) & 1) * bs;
        float* Dn = D + (t & 1) * bs;
        prefetch(t + 1);
        if (tab_sm)
            chains(std::true_type{}, t, Dc, Dn);
        else
            chains(std::false_type{}, t, Dc, Dn);
        if (ks > 1) {
            __syncthreads();
            // phase 2: the chains of (b, j) combined in chain order
            for (int it = threadIdx.x; it < items; it += nt) {
                const int b = it / s, j = it - b * s;
                float best = PV[b * s + j];
                int arg = PI[b * s + j];
                for (int c = 1; c < ks; ++c) {
                    const float v = PV[(c * B + b) * s + j];
                    if (v > best) {
                        best = v;
                        arg = PI[(c * B + b) * s + j];
                    }
                }
                finish(b, j, best, arg, t, Dn);
            }
        }
        wait_rows();
        __syncthreads();
    }
    // warp b: the argmax of utterance b's last delta, the frozen tail of its
    // path, then lane 0 walks the backpointers
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool own = warp < B && UN[warp] >= 0;
    int last = 0x7fffffff;
    if (own) {
        float v = -INFINITY;
        for (int j = lane; j < s; j += 32) mwd_argmax_pick(v, last, DL[warp * s + j], j);
        last = mwd_warp_argmax(v, last);
    }
    __syncthreads();  // the deltas are read: the buffers before UN are free
    if (!own) return;
    const int n = UN[warp], len = UN[B + warp];
    int* out = path + (long long)n * ts;
    for (int t = max(len - 1, 0) + lane; t < ts; t += 32) out[t] = last;
    const BP* bp = bp_of(warp);
    const long long row_bytes = (long long)s * sizeof(BP);
    const long long free_bytes = ((long long)L.un * sizeof(float) / B) & ~15LL;
    const int rows = (int)min(64LL, free_bytes / row_bytes);
    if (GLOB || bpg == nullptr || rows < 1) {
        if (lane == 0) {
            int state = last;
            for (int t = len - 1; t >= 1; --t) {
                state = bp[(long long)t * s + state];
                out[t - 1] = state;
            }
        }
        return;
    }
    // backpointers in device memory: the warp copies `rows` of them at a
    // time into its slice of the freed buffers (all loads in flight at
    // once), then lane 0 walks them in shared memory, so the walk's
    // dependent loads are shared-memory ones
    char* buf = reinterpret_cast<char*>(sm) + warp * free_bytes;
    const BP* bufp = reinterpret_cast<const BP*>(buf);
    int state = last;
    for (int hi = len - 1; hi >= 1; hi -= rows) {
        const int lo = max(1, hi - rows + 1);
        const char* src = reinterpret_cast<const char*>(bp + (long long)lo * s);
        const long long nb = (hi - lo + 1) * row_bytes;
        if (((reinterpret_cast<uintptr_t>(src) | nb) & 3) == 0) {
            for (long long i = 4 * lane; i < nb; i += 128)
                *reinterpret_cast<int*>(buf + i) = *reinterpret_cast<const int*>(src + i);
        } else {
            for (long long i = lane; i < nb; i += 32) buf[i] = src[i];
        }
        __syncwarp();
        if (lane == 0)
            for (int t = hi; t >= lo; --t) {
                state = bufp[(long long)(t - lo) * s + state];
                out[t - 1] = state;
            }
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Launch planning and the C entry points.
// ---------------------------------------------------------------------------

struct MwdVitPlan {
    int warp, b, nt, ks, tab_sm, bp_sm, glob;
    size_t smem;       // dynamic shared memory
    long long blocks;  // of the kernel
    long long floats;  // a block's buffers in device memory (glob)
};

static MwdVitPlan mwd_vit_plan(int n, int ts, int s) {
    MwdVitPlan p{};
    if (s <= 32) {
        const int per = MWD_VIT_WARPS * (32 / mwd_vit_sp(s));
        const size_t bp = (size_t)per * ts * s;
        p.warp = 1;
        p.blocks = (n + per - 1) / per;
        p.bp_sm = bp <= MWD_VIT_WARP_BP;
        p.smem = p.bp_sm ? bp : 0;
        return p;
    }
    static int n_sm = 0;  // of the card (queried once)
    if (n_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n_sm = 132;
    }
    // 8 utterances a block in large batches at S <= 64, 4 where that still
    // gives half a block an SM, else 1: a small batch spreads over SMs
    // rather than share base within a block
    p.b = s <= 64 && n >= MWD_VIT_B8_MIN ? 8 : (n + 3) / 4 >= n_sm / 2 ? 4 : 1;
    p.nt = s <= 128 ? MWD_VIT_NT : MWD_VIT_NT_BIG;
    p.ks = max(1, min(MWD_VIT_KS_MAX, p.nt / s));
    p.blocks = (n + p.b - 1) / p.b;
    // two blocks an SM where the batch takes more than one wave of blocks
    const size_t budgets[2] = {p.blocks > n_sm ? (size_t)MWD_SMEM_SM / 2 - 1024
                                               : (size_t)MWD_SMEM_OPTIN_MAX,
                               (size_t)MWD_SMEM_OPTIN_MAX};
    const int pref[4][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};  // (tab_sm, bp_sm)
    for (size_t budget : budgets)
        for (const auto& q : pref) {
            const MwdVitLayout L = mwd_vit_layout(s, ts, p.b, p.ks, q[0], q[1], false);
            if (L.bytes <= budget) {
                p.tab_sm = q[0];
                p.bp_sm = q[1];
                p.smem = L.bytes;
                return p;
            }
        }
    p.glob = 1;
    p.floats = mwd_vit_layout(s, ts, p.b, p.ks, false, false, true).floats;
    return p;
}

// The workspace, in bytes (each part 16-byte aligned): the length order
// (N ints, N * mwd_order_slices(N) partial ranks), the backpointers where
// they are in device memory, the blocks' buffers where they are.
struct MwdVitWork {
    long long perm, part, bp, gbuf, total;
};

static MwdVitWork mwd_vit_work(int n, int ts, int s, const MwdVitPlan& p) {
    auto up16 = [](long long x) { return (x + 15) & ~15LL; };
    MwdVitWork w;
    long long o = 0;
    w.perm = o; o += up16(4LL * n);
    w.part = o; o += up16(4LL * n * mwd_order_slices(n));
    w.bp = o;   o += p.bp_sm ? 0 : up16((long long)n * ts * s * mwd_vit_bp_size(s));
    w.gbuf = o; o += p.glob ? p.blocks * p.floats * 4 : 0;
    w.total = o;
    return w;
}

static bool mwd_vit_bad(int n, int ts, int s) { return s < 1 || ts < 1 || n < 0 || s > 65536; }

// Bytes of mwd_viterbi's workspace, or -1 for a shape it does not take.
extern "C" long long mwd_viterbi_work(int n, int ts, int s) {
    if (mwd_vit_bad(n, ts, s)) return -1;
    return mwd_vit_work(n, ts, s, mwd_vit_plan(n, ts, s)).total;
}

// 1 when the backpointers of a (Ts, S) decode of a small batch (one wave of
// blocks) stay in shared memory, else 0 (they go to the workspace).
extern "C" int mwd_viterbi_bp_in_smem(int ts, int s) {
    if (mwd_vit_bad(1, ts, s)) return 0;
    return mwd_vit_plan(1, ts, s).bp_sm;
}

template <typename Kernel, typename... Args>
static int mwd_vit_go(Kernel kernel, long long blocks, int threads, size_t smem,
                      cudaStream_t st, Args... args) {
    const int r = mwd_smem_optin(kernel, smem);
    if (r != 0) return r;
    kernel<<<(unsigned)blocks, threads, smem, st>>>(args...);
    return (int)cudaGetLastError();
}

// The length order, then the decode; work holds mwd_viterbi_work(n, ts, s)
// bytes.
extern "C" int mwd_viterbi(const float* base, const float* init, const float* rowz,
                           const float* colmask, const float* emit, const int* lens,
                           int* path, void* work, int n, int ts, int s, void* stream) {
    if (mwd_vit_bad(n, ts, s)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const MwdVitPlan p = mwd_vit_plan(n, ts, s);
    const MwdVitWork w = mwd_vit_work(n, ts, s, p);
    char* wk = static_cast<char*>(work);
    int* perm = reinterpret_cast<int*>(wk + w.perm);
    int* part = reinterpret_cast<int*>(wk + w.part);
    void* bpg = p.bp_sm ? nullptr : wk + w.bp;
    float* gbuf = reinterpret_cast<float*>(wk + w.gbuf);
    mwd_length_rank<<<mwd_order_grid(n), MWD_ORDER_NT, 0, st>>>(lens, n, part);
    mwd_viterbi_order<<<mwd_order_grid(n).x, MWD_ORDER_NT, 0, st>>>(part, n, perm);
    const int r = (int)cudaGetLastError();
    if (r != 0) return r;
#define MWD_VIT_ARGS base, init, rowz, colmask, emit, lens, perm, path
    if (p.warp) {
        const int th = MWD_VIT_WARPS * 32;
        uint8_t* bp8 = static_cast<uint8_t*>(bpg);
        switch (mwd_vit_sp(s)) {
            case 8: return mwd_vit_go(mwd_viterbi_warp<8>, p.blocks, th, p.smem, st, MWD_VIT_ARGS, bp8, n, ts, s);
            case 16: return mwd_vit_go(mwd_viterbi_warp<16>, p.blocks, th, p.smem, st, MWD_VIT_ARGS, bp8, n, ts, s);
            default: return mwd_vit_go(mwd_viterbi_warp<32>, p.blocks, th, p.smem, st, MWD_VIT_ARGS, bp8, n, ts, s);
        }
    }
#define MWD_VIT_BLK(B, BP, GLOB)                                                             \
    return mwd_vit_go(mwd_viterbi_blk<B, BP, GLOB>, p.blocks, p.nt, p.smem, st, MWD_VIT_ARGS, \
                      static_cast<BP*>(bpg), n, ts, s, p.ks, p.tab_sm, gbuf)
    if (p.b == 8) MWD_VIT_BLK(8, uint8_t, false);  // S <= 64: always in shared memory
    if (mwd_vit_bp_size(s) == 1) {
        if (p.b == 4) MWD_VIT_BLK(4, uint8_t, false);
        MWD_VIT_BLK(1, uint8_t, false);
    }
    if (p.b == 4) {
        if (!p.glob) MWD_VIT_BLK(4, uint16_t, false);
        MWD_VIT_BLK(4, uint16_t, true);
    }
    if (!p.glob) MWD_VIT_BLK(1, uint16_t, false);
    MWD_VIT_BLK(1, uint16_t, true);
#undef MWD_VIT_BLK
#undef MWD_VIT_ARGS
}
