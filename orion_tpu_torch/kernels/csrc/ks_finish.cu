// ks_finish: the key inner product and ModDown of a hybrid key-switch,
// over a batch of K items.  Item k takes ext[k % ext_count] (ext_count = K:
// paired; 1: one shared ext; E < K: E queries whose K / E rotations each
// share their query's decomposition) and key key_idx[k] of a stacked pack,
// and gives (2, nl, N) in the NTT domain;
// with moddown = 0 it stops after the inner product and gives the
// extended-basis accumulator (2, n_t, N) (ks_finish_raw).
//
// Replaces orion_tpu/crypto/ks_pallas.py ks_finish_pallas (body
// _finish_k, single-shot in VMEM) and ks_finish_pallas_grid (the same over
// a (digit, poly) grid that streams the key when it exceeds VMEM).  The
// TPU split exists only for VMEM's budget; Hopper has none, so one design
// covers every level:
//   launch A: grid (n_t, 2, K), one block per (extended row t, poly q,
//             item k) - sum_j ext[k, j, t] * ksk[key_idx[k], j, q, row(t)]
//             mod p_t (Shoup companions, or a Montgomery lift when the key
//             is lean).  Q rows (and every row without ModDown) go to the
//             work buffer as they are; special rows land in shared memory
//             and get their inverse NTT there first;
//   launch B: grid (nl, 2, K), one block per (Q row i, poly q, item k) -
//             the fast basis conversion of the special rows to q_i,
//             computed into the registers of the forward NTT's first pass,
//             the NTT, then (acc_q - lift) * P^-1 mod q_i.
// The conversion reads every special row of its poly, which is why the two
// halves meet at a launch boundary (blocks run in no order).  One launch
// pair covers a whole key pack (rotate_scan's baby steps, ext shared) or a
// transform's giant steps (ext paired), not one key-switch.
//
// Keys: a pack (n_keys, kdig, 2, krows, N), trimmed (kdig = dnum,
// krows = n_t) or full-chain (kdig >= dnum, krows = n_all); row_map[t]
// gives the key row of extended row t, so both layouts and every key of
// the pack are read in place: no gather, no copy.
//
// What bounds it: device memory, and at batch sizes the keys: 2 * dnum *
// n_t * N int64 words per item, twice that with Shoup companions, each read
// once, as 16-byte loads with the digit loop unrolled so that many are in
// flight.  A shared ext row is read once per (t, q) block; the block of
// the other poly finds it in L2.  The work buffer (K, 2, n_t, N) makes one
// round trip.  Everything else stays in registers and shared memory.

// On the ConjugateInvariant ring (CI = true, ci_pos non-null) rows hold n
// residues and the transforms run at N = 2n through the map of
// modarith.cuh: launch A's inner product covers the n positions, and a
// special row's result goes to a second shared buffer, from which the 2n
// inverse gathers (through ci_src) and keeps n coefficients; launch B
// converts those n coefficients, lifts the results into the 2n transform
// and stores through ci_pos.  This is orion_tpu's jnp key-switch on the
// CI ring, which its Pallas kernels refuse (ks_pallas.py ks_supported).

#include "modarith.cuh"

using namespace orion;

__device__ __forceinline__ longlong2 ld2(const int64_t* p) {
    return __ldg(reinterpret_cast<const longlong2*>(p));
}

// Shared memory of ks_inner_intt: the transform's, and on the CI ring a
// second buffer of the n inner products its inverse gathers from.
template <int LOGN, bool CI>
constexpr size_t inner_smem() {
    return Ring<LOGN>::SMEM
           + (CI ? sizeof(uint32_t) * row_width<LOGN, CI>() : 0);
}

template <int LOGN, bool CI>
__global__ void __launch_bounds__(Ring<LOGN>::T) ks_inner_intt(
        int64_t* __restrict__ work, const int64_t* __restrict__ ext,
        int ext_item, int ext_count, const int64_t* __restrict__ ksk,
        const int64_t* __restrict__ ksk_sh, const int64_t* key_idx,
        int kdig, int krows, const int64_t* row_map, int nl, int n_t,
        int dnum, int moddown, const int64_t* t_p, const int64_t* t_pinv,
        const int64_t* t_rmod, const int64_t* t_rsh, const int64_t* t_itwp,
        const int64_t* t_ninv, const int64_t* t_ninv_sh,
        const int64_t* ci_src) {
    extern __shared__ uint32_t s[];
    using RG = Ring<LOGN>;
    constexpr int N = RG::N;
    constexpr int W = row_width<LOGN, CI>();
    // the CI inner products, apart from the buffer the passes write
    uint32_t* acc = CI ? s + RG::SMEM / sizeof(uint32_t) : s;
    const int t = blockIdx.x;
    const int q = blockIdx.y;
    const int64_t k = blockIdx.z;
    const uint32_t p = (uint32_t)t_p[t];
    const bool lean = ksk_sh == nullptr;
    const uint32_t pinv = (uint32_t)t_pinv[t];
    const uint32_t rm = (uint32_t)t_rmod[t];
    const uint32_t rsh = (uint32_t)t_rsh[t];
    const bool special = moddown && t >= nl;
    const int64_t* e_row = ext + (k % ext_count) * ext_item + (int64_t)t * W;
    const int64_t e_dig = (int64_t)n_t * W;
    const int64_t k_off = key_idx[k] * ((int64_t)kdig * 2 * krows * W)
                          + ((int64_t)q * krows + row_map[t]) * W;
    const int64_t k_dig = (int64_t)2 * krows * W;
    int64_t* dst = work + ((k * 2 + q) * n_t + t) * W;
#pragma unroll
    for (int r = 0; r < RG::R * W / N / 2; ++r) {
        const int i = 2 * ((int)threadIdx.x + r * RG::T);
        uint32_t a0 = 0, a1 = 0;
#pragma unroll 4
        for (int j = 0; j < dnum; ++j) {
            const longlong2 e = ld2(e_row + j * e_dig + i);
            const longlong2 kv = ld2(ksk + k_off + j * k_dig + i);
            uint32_t t0, t1;
            if (lean) {
                t0 = mont_mul((uint32_t)e.x,
                              shoup_mul((uint32_t)kv.x, rm, rsh, p), p,
                              pinv);
                t1 = mont_mul((uint32_t)e.y,
                              shoup_mul((uint32_t)kv.y, rm, rsh, p), p,
                              pinv);
            } else {
                const longlong2 sv = ld2(ksk_sh + k_off + j * k_dig + i);
                t0 = shoup_mul((uint32_t)e.x, (uint32_t)kv.x,
                               (uint32_t)sv.x, p);
                t1 = shoup_mul((uint32_t)e.y, (uint32_t)kv.y,
                               (uint32_t)sv.y, p);
            }
            a0 = add_mod(a0, t0, p);
            a1 = add_mod(a1, t1, p);
        }
        if (special) {
            acc[CI ? i : pad(i)] = a0;
            acc[CI ? i + 1 : pad(i + 1)] = a1;
        } else {
            *reinterpret_cast<longlong2*>(dst + i) =
                make_longlong2((long long)a0, (long long)a1);
        }
    }
    if (!special) return;  // uniform per block
    __syncthreads();
    const uint32_t nv = (uint32_t)t_ninv[t];
    const uint32_t nv_sh = (uint32_t)t_ninv_sh[t];
    ntt_inv_row<LOGN>(
        s, t_itwp + (int64_t)t * N, p,
        [&](int i) {
            return CI ? acc[gather_at<CI>(ci_src, i)] : s[pad(i)];
        },
        [&](int i, uint32_t v) {
            if (!CI || i < W) dst[i] = shoup_mul(v, nv, nv_sh, p);
        });
}

template <int LOGN, bool CI>
__global__ void __launch_bounds__(Ring<LOGN>::T) moddown_rows(
        int64_t* out, const int64_t* work, int nl, int n_t, int n_sp,
        const int64_t* md_qi, const int64_t* md_qi_sh,
        const int64_t* md_srcp, const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* t_p, const int64_t* t_twp,
        const int64_t* ci_pos) {
    extern __shared__ uint32_t s[];
    constexpr int N = Ring<LOGN>::N;
    constexpr int W = row_width<LOGN, CI>();
    const int i = blockIdx.x;
    const int q = blockIdx.y;
    const int64_t k = blockIdx.z;
    const uint32_t p = (uint32_t)t_p[i];
    const int64_t* poly = work + (k * 2 + q) * n_t * W;
    const int64_t* sp = poly + (int64_t)nl * W;
    const int64_t* qrow = poly + (int64_t)i * W;
    int64_t* dst = out + ((k * 2 + q) * nl + i) * W;
    const uint32_t dm = (uint32_t)md_dmod[i];
    const uint32_t dm_sh = (uint32_t)md_dmod_sh[i];
    const uint32_t pv = (uint32_t)pinv_q[i];
    const uint32_t pv_sh = (uint32_t)pinv_q_sh[i];
    ntt_fwd_row<LOGN>(
        s, t_twp + (int64_t)i * N, p,
        [&](int c) {
            return lift_at<CI>(
                [&](int m) {
                    return fbc_one(sp + m, W, n_sp, md_qi, md_qi_sh,
                                   md_srcp, md_srcq, md_conv + i,
                                   md_conv_sh + i, nl, dm, dm_sh, p);
                },
                c, W, p);
        },
        [&](int c, uint32_t v) {
            keep_at<CI>(ci_pos, c, [&](int m) {
                dst[m] = shoup_mul(sub_mod((uint32_t)qrow[m], v, p), pv,
                                   pv_sh, p);
            });
        });
}

// Launch A: grid (n_t, 2, K).  Rows t >= nl get their inverse NTT when
// moddown is set (the special rows: with a row block's tables, nl is the
// block's first special row).
template <int LOGN, bool CI>
static cudaError_t inner_grid(
        int64_t* work, const int64_t* ext, int ext_item, int ext_count,
        const int64_t* ksk, const int64_t* ksk_sh, const int64_t* key_idx,
        const int64_t* row_map, int items, int kdig, int krows, int nl,
        int n_t, int dnum, int moddown, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* ci_src, cudaStream_t st) {
    constexpr size_t smem_a = inner_smem<LOGN, CI>();
    cudaError_t e = allow_smem(ks_inner_intt<LOGN, CI>, smem_a);
    if (e != cudaSuccess) return e;
    ks_inner_intt<LOGN, CI><<<dim3(n_t, 2, items), Ring<LOGN>::T, smem_a,
                              st>>>(
        work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx, kdig, krows,
        row_map, nl, n_t, dnum, moddown, t_p, t_pinv, t_rmod, t_rsh, t_itwp,
        t_ninv, t_ninv_sh, ci_src);
    return cudaGetLastError();
}

// Launch B: grid (nl, 2, K) over work (K, 2, n_t, N), whose rows nl.. are
// the special rows in the coefficient domain.
template <int LOGN, bool CI>
static cudaError_t moddown_grid(
        int64_t* out, const int64_t* work, int items, int nl, int n_t,
        const int64_t* md_qi, const int64_t* md_qi_sh,
        const int64_t* md_srcp, const float* md_srcq,
        const int64_t* md_conv, const int64_t* md_conv_sh,
        const int64_t* md_dmod, const int64_t* md_dmod_sh,
        const int64_t* pinv_q, const int64_t* pinv_q_sh, const int64_t* t_p,
        const int64_t* t_twp, const int64_t* ci_pos, cudaStream_t st) {
    using RG = Ring<LOGN>;
    cudaError_t e = allow_smem(moddown_rows<LOGN, CI>, RG::SMEM);
    if (e != cudaSuccess) return e;
    moddown_rows<LOGN, CI><<<dim3(nl, 2, items), RG::T, RG::SMEM, st>>>(
        out, work, nl, n_t, n_t - nl, md_qi, md_qi_sh, md_srcp, md_srcq,
        md_conv, md_conv_sh, md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, t_p,
        t_twp, ci_pos);
    return cudaGetLastError();
}

template <bool CI>
static int finish_launch(
        int64_t* out, int64_t* work, const int64_t* ext, int ext_item,
        int ext_count, const int64_t* ksk, const int64_t* ksk_sh,
        const int64_t* key_idx, const int64_t* row_map, int items, int kdig,
        int krows, int nl, int n_t, int dnum, int logn, int moddown,
        const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_twp, const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* md_qi,
        const int64_t* md_qi_sh, const int64_t* md_srcp,
        const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* ci_src,
        const int64_t* ci_pos, cudaStream_t st) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        cudaError_t e = inner_grid<LOGN, CI>(
            work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx, row_map,
            items, kdig, krows, nl, n_t, dnum, moddown, t_p, t_pinv, t_rmod,
            t_rsh, t_itwp, t_ninv, t_ninv_sh, ci_src, st);
        if (e != cudaSuccess || !moddown) return e;
        return moddown_grid<LOGN, CI>(
            out, work, items, nl, n_t, md_qi, md_qi_sh, md_srcp, md_srcq,
            md_conv, md_conv_sh, md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, t_p,
            t_twp, ci_pos, st);
    });
}

// ci_src, ci_pos: the CI ring's map (logn then the lift's), or both null.
extern "C" int orion_ks_finish(
        int64_t* out, int64_t* work, const int64_t* ext, int ext_item,
        int ext_count, const int64_t* ksk, const int64_t* ksk_sh,
        const int64_t* key_idx, const int64_t* row_map, int items, int kdig,
        int krows, int nl, int n_t, int dnum, int logn, int moddown,
        const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_twp, const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* md_qi,
        const int64_t* md_qi_sh, const int64_t* md_srcp,
        const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* ci_src,
        const int64_t* ci_pos, void* stream) {
    auto launch = ci_pos != nullptr ? finish_launch<true>
                                    : finish_launch<false>;
    return launch(out, work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx,
                  row_map, items, kdig, krows, nl, n_t, dnum, logn, moddown,
                  t_p, t_pinv, t_rmod, t_rsh, t_twp, t_itwp, t_ninv, t_ninv_sh,
                  md_qi, md_qi_sh, md_srcp, md_srcq, md_conv, md_conv_sh,
                  md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, ci_src, ci_pos,
                  (cudaStream_t)stream);
}

// The two launches of orion_ks_finish apart, standard ring only, for a
// limb-sharded key-switch (parallel/limbshard.py), whose all-reduce of the
// special rows sits between them.  Every table is that of the rows the
// grid covers: orion_ks_inner over a rank's n_t extended rows (row_map[t]
// the key row of row t, rows t >= nl special when moddown is set);
// orion_ks_moddown over work (K, 2, nl + n_sp, N): a rank's nl Q rows, then
// the n_sp special rows of the whole basis, summed over the ranks.
extern "C" int orion_ks_inner(
        int64_t* work, const int64_t* ext, int ext_item, int ext_count,
        const int64_t* ksk, const int64_t* ksk_sh, const int64_t* key_idx,
        const int64_t* row_map, int items, int kdig, int krows, int nl,
        int n_t, int dnum, int logn, int moddown, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, void* stream) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        return inner_grid<LOGN, false>(
            work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx, row_map,
            items, kdig, krows, nl, n_t, dnum, moddown, t_p, t_pinv, t_rmod,
            t_rsh, t_itwp, t_ninv, t_ninv_sh, nullptr, (cudaStream_t)stream);
    });
}

extern "C" int orion_ks_moddown(
        int64_t* out, const int64_t* work, int items, int nl, int n_t,
        int logn, const int64_t* md_qi, const int64_t* md_qi_sh,
        const int64_t* md_srcp, const float* md_srcq,
        const int64_t* md_conv, const int64_t* md_conv_sh,
        const int64_t* md_dmod, const int64_t* md_dmod_sh,
        const int64_t* pinv_q, const int64_t* pinv_q_sh, const int64_t* t_p,
        const int64_t* t_twp, void* stream) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        return moddown_grid<LOGN, false>(
            out, work, items, nl, n_t, md_qi, md_qi_sh, md_srcp, md_srcq,
            md_conv, md_conv_sh, md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, t_p,
            t_twp, nullptr, (cudaStream_t)stream);
    });
}
