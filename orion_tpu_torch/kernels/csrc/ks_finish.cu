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
//   launch A: ks_inner_intt, one block per (extended row t, poly q, item
//             k) - sum_j ext[k, j, t] * ksk[key_idx[k], j, q, row(t)]
//             mod p_t (Shoup companions, or a Montgomery lift when the key
//             is lean).  Q rows (and every row without ModDown) go to the
//             work buffer as they are.  With ModDown each special row gets
//             its inverse NTT in shared memory, whose store gives each
//             coefficient's zq = z * qhat_inv mod p as uint32 (one Shoup
//             product by n^-1 qhat_inv) into the special rows' part of the
//             work buffer;
//   launch V: hoist_digits, grid (N / 256, 1, 2K): v of each coefficient
//             of each poly from its n_sp zq, one byte, after them
//             (hoist.cuh): with launch A the digit-invariant half of
//             ModDown's conversion, once per source coefficient;
//   launch B: moddown_rows, one block per (Q row i, poly q, item k) - the
//             target half of the conversion of the special rows to q_i
//             (n_sp Shoup products and adds, one for v * dmod) into shared
//             memory, the forward NTT from there, then (acc_q - lift) *
//             P^-1 mod q_i.
// The conversion reads every special row of its poly, which is why the
// halves meet at launch boundaries (blocks run in no order).  One launch
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
// round trip.  Everything else stays in registers and shared memory.  On
// the H100 the batched calls run 6-8x above that bound, at the latency of
// the single-block transforms; two blocks of 1024 threads per SM (32
// registers, hoist.cuh ks_min_blocks) took a share of it.  A cluster split
// of launch A (each CTA the inner products of its sub-row, the special
// rows' inverse across the cluster) cut single calls by a few
// microseconds but lost at ResNet-20's batches and over its forward, so
// launch A stays one block per row.

// On the ConjugateInvariant ring (ci_pos non-null) rows hold n residues
// and the transforms run at N = 2n through the map of modarith.cuh, every
// row split over a thread-block cluster of C CTAs (cluster_ntt.cuh: 8 at a
// lift of 2^13 or 2^14, where one block per row left most SMs idle):
//   launch A: ks_inner_intt_ci, one cluster per (t, q, k), CTA c taking
//             slots [c n / C, (c + 1) n / C) of the inner product; a
//             special row's product at a slot goes straight to the two
//             inputs of the cluster's 2n inverse that hold it, in the
//             shared memory of the CTAs that transform them (distributed
//             shared memory), with no trip to device memory; the inverse
//             keeps n coefficients;
//   launch B: moddown_rows_ci, one cluster per (i, q, k): the forward on
//             the lift of the n converted coefficients, each converted
//             once (ntt_fwd_lift), stored through ci_pos.
// t_twp / t_itwp come packed in the split's order there.  This is
// orion_tpu's jnp key-switch on the CI ring, which its Pallas kernels
// refuse (ks_pallas.py ks_supported).

#include "cluster_ntt.cuh"
#include "hoist.cuh"

using namespace orion;

__device__ __forceinline__ longlong2 ld2(const int64_t* p) {
    return __ldg(reinterpret_cast<const longlong2*>(p));
}

// Positions i and i + 1 of one row's key inner product mod p: sum over the
// dnum digits j of e[j e_dig] * key[j k_dig] (e and key at position i),
// the key with its Shoup companions ksh, or lean (ksh null: a Montgomery
// lift).  16-byte loads, the digit loop unrolled so that many are in
// flight.
__device__ __forceinline__ void inner_pair(
        uint32_t& a0, uint32_t& a1, const int64_t* e, int64_t e_dig,
        const int64_t* key, const int64_t* ksh, int64_t k_dig, int dnum,
        uint32_t p, uint32_t pinv, uint32_t rm, uint32_t rsh) {
    a0 = a1 = 0;
#pragma unroll 4
    for (int j = 0; j < dnum; ++j) {
        const longlong2 ev = ld2(e + j * e_dig);
        const longlong2 kv = ld2(key + j * k_dig);
        uint32_t t0, t1;
        if (ksh == nullptr) {
            t0 = mont_mul((uint32_t)ev.x,
                          shoup_mul((uint32_t)kv.x, rm, rsh, p), p, pinv);
            t1 = mont_mul((uint32_t)ev.y,
                          shoup_mul((uint32_t)kv.y, rm, rsh, p), p, pinv);
        } else {
            const longlong2 sv = ld2(ksh + j * k_dig);
            t0 = shoup_mul((uint32_t)ev.x, (uint32_t)kv.x, (uint32_t)sv.x,
                           p);
            t1 = shoup_mul((uint32_t)ev.y, (uint32_t)kv.y, (uint32_t)sv.y,
                           p);
        }
        a0 = add_mod(a0, t0, p);
        a1 = add_mod(a1, t1, p);
    }
}

// What launch A does with the special rows t >= nl: nothing (every row
// stays in the NTT domain: ks_finish_raw), their inverse NTT into int64
// coefficients (a limb-sharded inner product, whose all-reduce sums them),
// or the inverse NTT into zq for ModDown's hoisted conversion.
enum SpecialRows : int { SP_NONE = 0, SP_COEFF = 1, SP_HOIST = 2 };

// The hoisted ModDown source in the work buffer (K, 2, n_t, N) int64: the
// special rows' part of a poly, n_sp * N words, holds zq (n_sp, N) uint32,
// then v (N) bytes.
__host__ __device__ inline uint32_t* md_zq(int64_t* poly, int nl, int n) {
    return reinterpret_cast<uint32_t*>(poly + (int64_t)nl * n);
}

// md_zs, md_zs_sh (n_sp): n^-1 qhat_inv of each special row (SP_HOIST).
template <int LOGN>
__global__ void __launch_bounds__(Ring<LOGN>::T, ks_min_blocks<LOGN>())
ks_inner_intt(
        int64_t* __restrict__ work, const int64_t* __restrict__ ext,
        int ext_item, int ext_count, const int64_t* __restrict__ ksk,
        const int64_t* __restrict__ ksk_sh, const int64_t* key_idx,
        int kdig, int krows, const int64_t* row_map, int nl, int n_t,
        int dnum, int special_rows, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* md_zs,
        const int64_t* md_zs_sh) {
    extern __shared__ uint32_t s[];
    using RG = Ring<LOGN>;
    constexpr int N = RG::N;
    const int t = blockIdx.x;
    const int q = blockIdx.y;
    const int64_t k = blockIdx.z;
    const uint32_t p = (uint32_t)t_p[t];
    const bool lean = ksk_sh == nullptr;
    const uint32_t pinv = (uint32_t)t_pinv[t];
    const uint32_t rm = (uint32_t)t_rmod[t];
    const uint32_t rsh = (uint32_t)t_rsh[t];
    const bool special = special_rows != SP_NONE && t >= nl;
    const int64_t* e_row = ext + (k % ext_count) * ext_item + (int64_t)t * N;
    const int64_t e_dig = (int64_t)n_t * N;
    const int64_t k_off = key_idx[k] * ((int64_t)kdig * 2 * krows * N)
                          + ((int64_t)q * krows + row_map[t]) * N;
    const int64_t k_dig = (int64_t)2 * krows * N;
    int64_t* poly = work + (k * 2 + q) * n_t * N;
    int64_t* dst = poly + (int64_t)t * N;
#pragma unroll
    for (int r = 0; r < RG::R / 2; ++r) {
        const int i = 2 * ((int)threadIdx.x + r * RG::T);
        uint32_t a0, a1;
        inner_pair(a0, a1, e_row + i, e_dig, ksk + k_off + i,
                   lean ? nullptr : ksk_sh + k_off + i, k_dig, dnum, p,
                   pinv, rm, rsh);
        if (special) {
            s[pad(i)] = a0;
            s[pad(i + 1)] = a1;
        } else {
            *reinterpret_cast<longlong2*>(dst + i) =
                make_longlong2((long long)a0, (long long)a1);
        }
    }
    if (!special) return;  // uniform per block
    __syncthreads();
    auto own = [&](int i) { return s[pad(i)]; };
    if (special_rows == SP_COEFF) {
        const uint32_t nv = (uint32_t)t_ninv[t];
        const uint32_t nv_sh = (uint32_t)t_ninv_sh[t];
        ntt_inv_row<LOGN>(
            s, t_itwp + (int64_t)t * N, p, own,
            [&](int i, uint32_t v) { dst[i] = shoup_mul(v, nv, nv_sh, p); });
        return;
    }
    const uint32_t w = (uint32_t)md_zs[t - nl];
    const uint32_t w_sh = (uint32_t)md_zs_sh[t - nl];
    uint32_t* dz = md_zq(poly, nl, N) + (int64_t)(t - nl) * N;
    ntt_inv_row<LOGN>(
        s, t_itwp + (int64_t)t * N, p, own,
        [&](int i, uint32_t v) { dz[i] = shoup_mul(v, w, w_sh, p); });
}

// The CI form of ks_inner_intt: cluster (x / C, y, z) = (t, q, k), rows
// of W = N / 2 residues; CTA c computes slots [c SEG, (c + 1) SEG), SEG =
// W / C.  A special row's product at slot j feeds the two inputs of the
// 2n inverse that hold it, keep(j) and N - 1 - keep(j) (ci_keep_pos): the
// CTA stores it straight into the shared memory of the CTAs whose sub-rows
// hold them, each warp's store into one CTA, and the inverse reads its
// sub-row from its own memory.
template <int LOGN>
__global__ void __launch_bounds__(Split<LOGN>::T) ks_inner_intt_ci(
        int64_t* __restrict__ work, const int64_t* __restrict__ ext,
        int ext_item, int ext_count, const int64_t* __restrict__ ksk,
        const int64_t* __restrict__ ksk_sh, const int64_t* key_idx,
        int kdig, int krows, const int64_t* row_map, int nl, int n_t,
        int dnum, int moddown, const int64_t* t_p, const int64_t* t_pinv,
        const int64_t* t_rmod, const int64_t* t_rsh, const int64_t* t_itwc,
        const int64_t* t_ninv, const int64_t* t_ninv_sh) {
    extern __shared__ uint32_t s[];
    using SP = Split<LOGN>;
    constexpr int N = 1 << LOGN;
    constexpr int W = N / 2;
    constexpr int SEG = W / SP::C;
    constexpr int IT = SEG / (2 * SP::T);
    static_assert(IT * 2 * SP::T == SEG, "slots must split evenly");
    const int t = blockIdx.x / SP::C;
    const int lo = (int)(blockIdx.x % SP::C) * SEG;
    const int q = blockIdx.y;
    const int64_t k = blockIdx.z;
    const uint32_t p = (uint32_t)t_p[t];
    const bool lean = ksk_sh == nullptr;
    const uint32_t pinv = (uint32_t)t_pinv[t];
    const uint32_t rm = (uint32_t)t_rmod[t];
    const uint32_t rsh = (uint32_t)t_rsh[t];
    const bool special = moddown && t >= nl;  // uniform per cluster
    if constexpr (SP::C > 1)
        if (special) cluster_arrive_relaxed();
    const int64_t* e_row = ext + (k % ext_count) * ext_item + (int64_t)t * W;
    const int64_t e_dig = (int64_t)n_t * W;
    const int64_t k_off = key_idx[k] * ((int64_t)kdig * 2 * krows * W)
                          + ((int64_t)q * krows + row_map[t]) * W;
    const int64_t k_dig = (int64_t)2 * krows * W;
    int64_t* dst = work + ((k * 2 + q) * n_t + t) * W;
    uint32_t a[IT][2];
#pragma unroll
    for (int r = 0; r < IT; ++r) {
        const int i = lo + 2 * ((int)threadIdx.x + r * SP::T);
        inner_pair(a[r][0], a[r][1], e_row + i, e_dig, ksk + k_off + i,
                   lean ? nullptr : ksk_sh + k_off + i, k_dig, dnum, p,
                   pinv, rm, rsh);
        if (!special)
            *reinterpret_cast<longlong2*>(dst + i) =
                make_longlong2((long long)a[r][0], (long long)a[r][1]);
    }
    if (!special) return;
    // input g of the inverse lives in CTA g / M at g % M
    auto put = [&](int g, uint32_t v) {
        uint32_t* at = s + pad(g & (SP::M - 1));
        if constexpr (SP::C == 1) *at = v;
        else *cg::this_cluster().map_shared_rank(at, g >> SP::LOGM) = v;
    };
    if constexpr (SP::C == 1) {
#pragma unroll
        for (int r = 0; r < IT; ++r) {
            const int j = lo + 2 * ((int)threadIdx.x + r * SP::T);
            uint32_t w = pow5_mod2n<LOGN>(j);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int g = ci_keep_pos<LOGN>(w);
                put(g, a[r][h]);
                put(N - 1 - g, a[r][h]);
                w = (w * 5u) & ((2u << LOGN) - 1);  // slot j + 1
            }
        }
        __syncthreads();
    } else {
        // The sub-row of keep(j) depends on j mod H alone (on 5^j mod
        // 2^(LOGC+1)), and its mirror's is C - 1 minus it.  So the products
        // are staged in slot order in the receive buffer, which no other
        // CTA writes before the inverse's first barrier, and pushed by
        // warps whose 32 slots share j mod H: each warp's store goes to
        // one CTA, where slots in order would scatter it over C.
        constexpr int H = SP::C / 2;
        static_assert(SEG % SP::T == 0 && (SEG / 32) % H == 0,
                      "warps must split the slots by residue");
        uint32_t* stage = s + SP::Core::SMEM / sizeof(uint32_t);
#pragma unroll
        for (int r = 0; r < IT; ++r) {
            const int o = 2 * ((int)threadIdx.x + r * SP::T);
            stage[pad(o)] = a[r][0];
            stage[pad(o + 1)] = a[r][1];
        }
        __syncthreads();
        cluster_wait();  // every CTA has started
#pragma unroll
        for (int u = 0; u < SEG / SP::T; ++u) {
            const int v = (int)threadIdx.x + u * SP::T;
            const int wv = v >> 5;
            const int o = (wv / H) * (32 * H) + (v & 31) * H + wv % H;
            const uint32_t x = stage[pad(o)];
            const int g = ci_keep_pos<LOGN>(pow5_mod2n<LOGN>(lo + o));
            put(g, x);
            put(N - 1 - g, x);
        }
        // ntt_inv_split's first barrier orders the stores
    }
    const uint32_t nv = (uint32_t)t_ninv[t];
    const uint32_t nv_sh = (uint32_t)t_ninv_sh[t];
    ntt_inv_split<LOGN>(
        s, t_itwc + (int64_t)t * N, p,
        [&](int g) { return s[pad(g & (SP::M - 1))]; },
        [&](int i, uint32_t v) {
            if (i < W) dst[i] = shoup_mul(v, nv, nv_sh, p);
        });
}

// Launch B: block (i, q, k) divides Q row i of poly (k, q) by P.  Its Q
// row is at work + (k * 2 + q) * work_poly + i * N (int64, NTT domain); the
// hoisted special rows of the poly at zq + (k * 2 + q) * zq_poly (n_sp
// rows of N uint32) and vb + (k * 2 + q) * v_poly (N bytes).
template <int LOGN>
__global__ void __launch_bounds__(Ring<LOGN>::T, ks_min_blocks<LOGN>())
moddown_rows(
        int64_t* out, const int64_t* work, int64_t work_poly,
        const uint32_t* zq, int64_t zq_poly, const uint8_t* vb,
        int64_t v_poly, int nl, int n_sp, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* t_p, const int64_t* t_twp) {
    extern __shared__ uint32_t s[];
    constexpr int N = Ring<LOGN>::N;
    const int i = blockIdx.x;
    const int q = blockIdx.y;
    const int64_t k = blockIdx.z;
    const int64_t kq = k * 2 + q;
    const uint32_t p = (uint32_t)t_p[i];
    const int64_t* qrow = work + kq * work_poly + (int64_t)i * N;
    const uint32_t* z = zq + kq * zq_poly;
    const uint8_t* v = vb + kq * v_poly;
    int64_t* dst = out + (kq * nl + i) * N;
    u64* cw = reinterpret_cast<u64*>(s + Ring<LOGN>::SMEM / sizeof(uint32_t));
    stage_conv(cw, md_conv + i, md_conv_sh + i, nl, n_sp);
    const uint32_t dm = (uint32_t)md_dmod[i];
    const uint32_t dm_sh = (uint32_t)md_dmod_sh[i];
    const uint32_t pv = (uint32_t)pinv_q[i];
    const uint32_t pv_sh = (uint32_t)pinv_q_sh[i];
    __syncthreads();
    hoist_target<LOGN>(s, z, N, v, n_sp, cw, dm, dm_sh, p);
    __syncthreads();
    ntt_fwd_row<LOGN>(
        s, t_twp + (int64_t)i * N, p, [&](int c) { return s[pad(c)]; },
        [&](int c, uint32_t x) {
            dst[c] = shoup_mul(sub_mod((uint32_t)qrow[c], x, p), pv, pv_sh,
                               p);
        });
}

// The CI form of moddown_rows: cluster (x / C, y, z) = (i, q, k), rows of
// W = N / 2 residues, each special-row coefficient converted once.
template <int LOGN>
__global__ void __launch_bounds__(Split<LOGN>::T) moddown_rows_ci(
        int64_t* out, const int64_t* work, int nl, int n_t, int n_sp,
        const int64_t* md_qi, const int64_t* md_qi_sh,
        const int64_t* md_srcp, const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* t_p, const int64_t* t_twc,
        const int64_t* ci_pos) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    constexpr int W = N / 2;
    const int i = blockIdx.x / Split<LOGN>::C;
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
    ntt_fwd_lift<LOGN>(
        s, t_twc + (int64_t)i * N, p,
        [&](int m) {
            return fbc_one(sp + m, W, n_sp, md_qi, md_qi_sh, md_srcp,
                           md_srcq, md_conv + i, md_conv_sh + i, nl, dm,
                           dm_sh, p);
        },
        [&](int g, uint32_t v) {
            keep_at<true>(ci_pos, g, [&](int m) {
                dst[m] = shoup_mul(sub_mod((uint32_t)qrow[m], v, p), pv,
                                   pv_sh, p);
            });
        });
}

// Launch A: grid (n_t, 2, K), rows t >= nl (with a row block's tables,
// nl is the block's first special row) as special_rows says.
template <int LOGN>
static cudaError_t inner_grid(
        int64_t* work, const int64_t* ext, int ext_item, int ext_count,
        const int64_t* ksk, const int64_t* ksk_sh, const int64_t* key_idx,
        const int64_t* row_map, int items, int kdig, int krows, int nl,
        int n_t, int dnum, int special_rows, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_itwp, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* md_zs,
        const int64_t* md_zs_sh, cudaStream_t st) {
    using RG = Ring<LOGN>;
    cudaError_t e = allow_smem(ks_inner_intt<LOGN>, RG::SMEM);
    if (e != cudaSuccess) return e;
    ks_inner_intt<LOGN><<<dim3(n_t, 2, items), RG::T, RG::SMEM, st>>>(
        work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx, kdig, krows,
        row_map, nl, n_t, dnum, special_rows, t_p, t_pinv, t_rmod, t_rsh,
        t_itwp, t_ninv, t_ninv_sh, md_zs, md_zs_sh);
    return cudaGetLastError();
}

// Launch B: grid (nl, 2, K), Q row i of item k's poly q at work + (k * 2
// + q) * work_poly + i * N, its hoisted special rows as moddown_rows reads
// them.
template <int LOGN>
static cudaError_t moddown_grid(
        int64_t* out, const int64_t* work, int64_t work_poly,
        const uint32_t* zq, int64_t zq_poly, const uint8_t* vb,
        int64_t v_poly, int items, int nl, int n_sp, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* t_p, const int64_t* t_twp,
        cudaStream_t st) {
    using RG = Ring<LOGN>;
    if (n_sp < 1 || n_sp > MAX_ALPHA) return cudaErrorInvalidValue;
    constexpr size_t smem = RG::SMEM + CONV_SMEM;
    cudaError_t e = allow_smem(moddown_rows<LOGN>, smem);
    if (e != cudaSuccess) return e;
    moddown_rows<LOGN><<<dim3(nl, 2, items), RG::T, smem, st>>>(
        out, work, work_poly, zq, zq_poly, vb, v_poly, nl, n_sp, md_conv,
        md_conv_sh, md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, t_p, t_twp);
    return cudaGetLastError();
}

// The launch pair of orion_ks_finish, standard ring (CI = false) or, with
// the map, the CI ring's cluster kernels (t_twp / t_itwp in the split's
// order).
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
        const int64_t* pinv_q_sh, const int64_t* md_zs,
        const int64_t* md_zs_sh, const int64_t* ci_pos, cudaStream_t st) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        cudaError_t e;
        if constexpr (CI) {
            e = launch_split_grid<LOGN>(
                ks_inner_intt_ci<LOGN>, n_t, 2, items, Split<LOGN>::SMEM_INV,
                st, work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx,
                kdig, krows, row_map, nl, n_t, dnum, moddown, t_p, t_pinv,
                t_rmod, t_rsh, t_itwp, t_ninv, t_ninv_sh);
            if (e != cudaSuccess || !moddown) return e;
            return launch_split_grid<LOGN>(
                moddown_rows_ci<LOGN>, nl, 2, items, Split<LOGN>::SMEM_LIFT,
                st, out, work, nl, n_t, n_t - nl, md_qi, md_qi_sh, md_srcp,
                md_srcq, md_conv, md_conv_sh, md_dmod, md_dmod_sh, pinv_q,
                pinv_q_sh, t_p, t_twp, ci_pos);
        } else {
            constexpr int N = 1 << LOGN;
            e = inner_grid<LOGN>(
                work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx,
                row_map, items, kdig, krows, nl, n_t, dnum,
                moddown ? SP_HOIST : SP_NONE, t_p, t_pinv, t_rmod, t_rsh,
                t_itwp, t_ninv, t_ninv_sh, md_zs, md_zs_sh, st);
            if (e != cudaSuccess || !moddown) return e;
            // V, then B: zq (n_sp, N) and v (N) of poly (k, q) in its
            // special rows' part of work
            const int n_sp = n_t - nl;
            uint32_t* zq = md_zq(work, nl, N);
            uint8_t* vb = reinterpret_cast<uint8_t*>(zq + (int64_t)n_sp * N);
            e = launch_hoist(zq, vb, nullptr, 0, (int64_t)2 * n_t * N,
                             (int64_t)8 * n_t * N, N, 1, items * 2, n_sp,
                             nullptr, nullptr, md_qi, md_qi_sh, md_srcp,
                             md_srcq, st);
            if (e != cudaSuccess) return e;
            return moddown_grid<LOGN>(
                out, work, (int64_t)n_t * N, zq, (int64_t)2 * n_t * N, vb,
                (int64_t)8 * n_t * N, items, nl, n_sp, md_conv, md_conv_sh,
                md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, t_p, t_twp, st);
        }
    });
}

// ci_src, ci_pos: the CI ring's map (logn then the lift's), or both null.
// The CI form reads ci_pos; its inverse's gather follows from the map's
// closed form (modarith.cuh ci_keep_pos), so ci_src is not read.
// md_zs, md_zs_sh (n_sp): the standard form's constants of the special
// rows' inverse (n^-1 qhat_inv, kernels/keyswitch.py `_finish_tables`),
// null on the CI ring.
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
        const int64_t* pinv_q_sh, const int64_t* md_zs,
        const int64_t* md_zs_sh, const int64_t* ci_src,
        const int64_t* ci_pos, void* stream) {
    auto launch = ci_pos != nullptr ? finish_launch<true>
                                    : finish_launch<false>;
    return launch(out, work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx,
                  row_map, items, kdig, krows, nl, n_t, dnum, logn, moddown,
                  t_p, t_pinv, t_rmod, t_rsh, t_twp, t_itwp, t_ninv, t_ninv_sh,
                  md_qi, md_qi_sh, md_srcp, md_srcq, md_conv, md_conv_sh,
                  md_dmod, md_dmod_sh, pinv_q, pinv_q_sh, md_zs, md_zs_sh,
                  ci_pos, (cudaStream_t)stream);
}

// The two launches of orion_ks_finish apart, standard ring only, for a
// limb-sharded key-switch (parallel/limbshard.py), whose all-reduce of the
// special rows sits between them.  Every table is that of the rows the
// grid covers: orion_ks_inner over a rank's n_t extended rows (row_map[t]
// the key row of row t, rows t >= nl special when moddown is set, left as
// int64 coefficients); orion_ks_moddown over work (K, 2, nl + n_sp, N): a
// rank's nl Q rows, then the n_sp special rows of the whole basis, summed
// over the ranks, in the coefficient domain.  Its prologue pass
// (hoist_digits) hoists their zq and v into scratch that the caller leaves
// behind out: out's buffer holds K * 2 * N * (4 n_sp + 1) bytes past its
// K * 2 * nl * N words.
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
        return inner_grid<LOGN>(
            work, ext, ext_item, ext_count, ksk, ksk_sh, key_idx, row_map,
            items, kdig, krows, nl, n_t, dnum, moddown ? SP_COEFF : SP_NONE,
            t_p, t_pinv, t_rmod, t_rsh, t_itwp, t_ninv, t_ninv_sh, nullptr,
            nullptr, (cudaStream_t)stream);
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
        constexpr int N = 1 << LOGN;
        const cudaStream_t st = (cudaStream_t)stream;
        const int n_sp = n_t - nl;
        uint32_t* zq = reinterpret_cast<uint32_t*>(
            out + (int64_t)items * 2 * nl * N);
        uint8_t* vb = reinterpret_cast<uint8_t*>(
            zq + (int64_t)items * 2 * n_sp * N);
        cudaError_t e = launch_hoist(
            zq, vb, work + (int64_t)nl * N, (int64_t)n_t * N,
            (int64_t)n_sp * N, N, N, 1, items * 2, n_sp, nullptr, nullptr,
            md_qi, md_qi_sh, md_srcp, md_srcq, st);
        if (e != cudaSuccess) return e;
        return moddown_grid<LOGN>(
            out, work, (int64_t)n_t * N, zq, (int64_t)n_sp * N, vb, N,
            items, nl, n_sp, md_conv, md_conv_sh, md_dmod, md_dmod_sh,
            pinv_q, pinv_q_sh, t_p, t_twp, st);
    });
}
