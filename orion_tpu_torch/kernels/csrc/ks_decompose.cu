// ks_decompose: the hoistable half of a hybrid key-switch, over a batch.
// c (B, nl, N) in the NTT domain -> ext (B, dnum, n_t, N) in the NTT
// domain, where digit d's alpha source limbs are converted to all
// n_t = nl + n_sp target primes.
//
// Replaces orion_tpu/crypto/ks_pallas.py ks_decompose_pallas (bodies
// _decompose_k, _fbc_k), which keeps the whole decomposition in one VMEM
// program, and ks_decompose_pallas_grid, the same function streamed one
// digit per grid step with the digit constants padded to alpha_max (deep
// levels: 4 digits at levels 6-7 of configs/lenet.yml).  Here every digit
// reads its own alpha from dig_alpha, so an unequal last digit needs no
// padded source rows.  Hopper's thread blocks run in no order, and the basis
// conversion of one target row reads every source limb of its digit, so
// the work is split at launch boundaries, two gaps per batch:
//   launch A: ntt_inv_zq, one thread-block cluster per (Q row, poly)
//             (cluster_ntt.cuh's split inverse: 8 CTAs per row at LogN 13
//             and 14): the inverse NTT, whose store gives each
//             coefficient's zq = z * qhat_inv mod q as uint32 (one Shoup
//             product by n^-1 qhat_inv, where the plain inverse scales by
//             n^-1);
//   launch V: hoist_digits, grid (N / 256, dnum, B): v of each (digit,
//             coefficient, poly) from the digit's alpha zq, one byte
//             (hoist.cuh): with launch A the digit-invariant half of the
//             conversion, once per source coefficient;
//   launch B: fbc_ntt_digits, grid (n_t, dnum, B): the target half of the
//             conversion (alpha Shoup products and adds, one for v * dmod)
//             into shared memory, the forward NTT with row t's tables from
//             there, and one write of ext[b, d, t].
// zq and v live in the coefficient scratch the caller gives (B, nl, N)
// int64: zq (B, nl, N) uint32 in its first half, v (B, dnum, N) bytes
// after it.  The batch is the giant steps of one BSGS transform (or one
// poly): launch B has n_t * dnum * B blocks, 40 * B at configs/lenet.yml's
// level 7, so a batch fills the 132 SMs where one key-switch cannot.
//
// What bounds it: by the count of the bound, the integer multiplies at
// configs/resnet.yml's deep levels (3 alpha + 3 per output coefficient
// beside the transform's) and device memory at shallow ones; on the H100
// it runs about 8x above that at ResNet-20's batches and deep levels, at
// the latency of launch B's single-block transforms (two blocks of 1024
// threads per SM, hoist.cuh ks_min_blocks, and the hoist each took a
// share of it: PERF.md, Findings).  It reads c and
// writes ext once (int64), plus the scratch round trip (4 alpha + 1 bytes
// per source coefficient, where it was 8 alpha) and the packed twiddle
// tables; launch B re-reads a digit's zq and v once per target row (n_t
// times), from L2.  The transforms stay in registers and shared memory.
//
// On the ConjugateInvariant ring (ci_pos non-null) rows hold n residues
// and the transforms run at N = 2n through the map of modarith.cuh, every
// row split over a thread-block cluster (cluster_ntt.cuh: 8 CTAs per row
// at a lift of 2^13 or 2^14, where one block per row left most of the 132
// SMs idle):
//   launch A: ntt_inv_cluster, one cluster per Q row of each poly,
//             gathering through ci_src and keeping n coefficients;
//   launch B: fbc_ntt_digits_ci, one cluster per (target row, digit,
//             poly): each of the n coefficients is converted once, in the
//             CTA whose slab holds it, and its mirror in the 2n lift is
//             the negation of that conversion (ntt_fwd_lift), never a
//             conversion of mirrored residues, whose float32 v-correction
//             could round otherwise; the store goes through ci_pos.
// This is orion_tpu's jnp key-switch on the CI ring, which its Pallas
// kernels refuse (ks_pallas.py ks_supported).
//
// Table layouts (all contiguous int64 except srcq, float32):
//   dig_lo, dig_alpha (dnum); qi, qi_sh, srcp, srcq (dnum, amax);
//   conv, conv_sh (dnum, amax, n_t); dmod, dmod_sh (dnum, n_t);
//   t_* are the target rows' tables (Q rows 0..nl-1 first, then specials),
//   t_twp packed as modarith.cuh describes (the core's order); t_itwp the
//   Q rows' inverse tables in the split's order (cluster_ntt.cuh); on the
//   CI ring both in the split's order.

#include "cluster_ntt.cuh"
#include "hoist.cuh"

using namespace orion;

// Launch A: cluster (x / C, y) of Split<LOGN>::C CTAs transforms Q row
// x / C of poly y (cluster_ntt.cuh's split inverse, t_itwc its table in
// the split's order) and stores its zq (uint32, scratch zq (B, nl, N)):
// the store's constant zs[x / C] = n^-1 * qhat_inv mod q of the row's
// digit (kernels/keyswitch.py folds them).
template <int LOGN>
__global__ void __launch_bounds__(Split<LOGN>::T) ntt_inv_zq(
        uint32_t* zq, const int64_t* c, int nl, const int64_t* t_p,
        const int64_t* t_itwc, const int64_t* zs, const int64_t* zs_sh) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    const int row = blockIdx.x / Split<LOGN>::C;
    const int64_t off = ((int64_t)blockIdx.y * nl + row) * N;
    const uint32_t p = (uint32_t)t_p[row];
    const uint32_t w = (uint32_t)zs[row];
    const uint32_t w_sh = (uint32_t)zs_sh[row];
    const int64_t* src = c + off;
    uint32_t* dst = zq + off;
    ntt_inv_split<LOGN>(
        s, t_itwc + (int64_t)row * N, p,
        [&](int i) { return (uint32_t)src[i]; },
        [&](int i, uint32_t x) { dst[i] = shoup_mul(x, w, w_sh, p); });
}

// Launch B: block (t, d, b) converts digit d of poly b onto target row t
// from the hoisted zq and v and transforms it.
template <int LOGN>
__global__ void __launch_bounds__(Ring<LOGN>::T, ks_min_blocks<LOGN>())
fbc_ntt_digits(
        int64_t* ext, const uint32_t* zq, const uint8_t* vb, int nl,
        int n_t, int dnum, int amax, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twp) {
    extern __shared__ uint32_t s[];
    constexpr int N = Ring<LOGN>::N;
    const int t = blockIdx.x;
    const int d = blockIdx.y;
    const int64_t b = blockIdx.z;
    const uint32_t pt = (uint32_t)t_p[t];
    const int alpha = (int)dig_alpha[d];
    const uint32_t* z = zq + (b * nl + dig_lo[d]) * N;
    const uint8_t* v = vb + (b * dnum + d) * N;
    const int64_t dg = (int64_t)d * amax;
    u64* cw = reinterpret_cast<u64*>(s + Ring<LOGN>::SMEM / sizeof(uint32_t));
    stage_conv(cw, conv + dg * n_t + t, conv_sh + dg * n_t + t, n_t, alpha);
    const uint32_t dm = (uint32_t)dmod[(int64_t)d * n_t + t];
    const uint32_t dm_sh = (uint32_t)dmod_sh[(int64_t)d * n_t + t];
    int64_t* dst = ext + ((b * dnum + d) * n_t + t) * N;
    __syncthreads();
    hoist_target<LOGN>(s, z, N, v, alpha, cw, dm, dm_sh, pt);
    __syncthreads();
    ntt_fwd_row<LOGN>(
        s, t_twp + (int64_t)t * N, pt, [&](int i) { return s[pad(i)]; },
        [&](int i, uint32_t x) { dst[i] = x; });
}

// The CI form of fbc_ntt_digits: cluster (x / C, y, z) = (target row t,
// digit d, poly b), rows of W = N / 2 residues, the transform on their
// lift with each coefficient converted once.
template <int LOGN>
__global__ void __launch_bounds__(Split<LOGN>::T) fbc_ntt_digits_ci(
        int64_t* ext, const int64_t* coeff, int nl, int n_t, int dnum,
        int amax, const int64_t* dig_lo, const int64_t* dig_alpha,
        const int64_t* qi, const int64_t* qi_sh, const int64_t* srcp,
        const float* srcq, const int64_t* conv, const int64_t* conv_sh,
        const int64_t* dmod, const int64_t* dmod_sh, const int64_t* t_p,
        const int64_t* t_twc, const int64_t* ci_pos) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    constexpr int W = N / 2;
    const int t = blockIdx.x / Split<LOGN>::C;
    const int d = blockIdx.y;
    const int64_t b = blockIdx.z;
    const uint32_t pt = (uint32_t)t_p[t];
    const int alpha = (int)dig_alpha[d];
    const int64_t* z = coeff + (b * nl + dig_lo[d]) * W;
    const int64_t dg = (int64_t)d * amax;
    const int64_t* cv = conv + dg * n_t + t;
    const int64_t* cv_sh = conv_sh + dg * n_t + t;
    const uint32_t dm = (uint32_t)dmod[(int64_t)d * n_t + t];
    const uint32_t dm_sh = (uint32_t)dmod_sh[(int64_t)d * n_t + t];
    int64_t* dst = ext + ((b * dnum + d) * n_t + t) * W;
    ntt_fwd_lift<LOGN>(
        s, t_twc + (int64_t)t * N, pt,
        [&](int k) {
            return fbc_one(z + k, W, alpha, qi + dg, qi_sh + dg, srcp + dg,
                           srcq + dg, cv, cv_sh, n_t, dm, dm_sh, pt);
        },
        [&](int i, uint32_t v) {
            keep_at<true>(ci_pos, i, [&](int k) { dst[k] = v; });
        });
}

// Launch B over the hoisted scratch (zq (batch, nl, N), vb (batch, dnum,
// N)): every digit onto the n_t target rows whose tables are given.  With
// a row block's tables (n_t its row count) this is a limb-sharded
// key-switch's conversion onto one rank's rows (parallel/limbshard.py).
template <int LOGN>
static cudaError_t convert_grid(
        int64_t* ext, const uint32_t* zq, const uint8_t* vb, int batch,
        int nl, int n_t, int dnum, int amax, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twp, cudaStream_t st) {
    using RG = Ring<LOGN>;
    constexpr size_t smem = RG::SMEM + CONV_SMEM;
    cudaError_t e = allow_smem(fbc_ntt_digits<LOGN>, smem);
    if (e != cudaSuccess) return e;
    fbc_ntt_digits<LOGN><<<dim3(n_t, dnum, batch), RG::T, smem, st>>>(
        ext, zq, vb, nl, n_t, dnum, amax, dig_lo, dig_alpha, conv, conv_sh,
        dmod, dmod_sh, t_p, t_twp);
    return cudaGetLastError();
}

// The hoisted scratch inside an int64 buffer: zq (batch, nl, N) uint32,
// then v (batch, dnum, N) bytes.
static uint8_t* hoisted_v(uint32_t* zq, int batch, int nl, int n) {
    return reinterpret_cast<uint8_t*>(zq + (int64_t)batch * nl * n);
}

static int decompose_launch(
        int64_t* ext, int64_t* coeff, const int64_t* c, int batch, int nl,
        int n_t, int dnum, int amax, int logn, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* qi, const int64_t* qi_sh,
        const int64_t* srcp, const float* srcq, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twp, const int64_t* t_itwp,
        const int64_t* zs, const int64_t* zs_sh, cudaStream_t st) {
    if (amax < 1 || amax > MAX_ALPHA) return (int)cudaErrorInvalidValue;
    return (int)with_logn(logn, [&](auto cst) {
        constexpr int LOGN = decltype(cst)::value;
        constexpr int N = 1 << LOGN;
        uint32_t* zq = reinterpret_cast<uint32_t*>(coeff);
        uint8_t* vb = hoisted_v(zq, batch, nl, N);
        // A: the Q rows are the first nl rows of the target tables
        cudaError_t e = launch_split_grid<LOGN>(
            ntt_inv_zq<LOGN>, nl, batch, 1, Split<LOGN>::SMEM_INV, st, zq, c,
            nl, t_p, t_itwp, zs, zs_sh);
        if (e != cudaSuccess) return e;
        // V
        e = launch_hoist(zq, vb, nullptr, 0, (int64_t)nl * N,
                         (int64_t)dnum * N, N, dnum, batch, amax, dig_lo,
                         dig_alpha, qi, qi_sh, srcp, srcq, st);
        if (e != cudaSuccess) return e;
        // B
        return convert_grid<LOGN>(
            ext, zq, vb, batch, nl, n_t, dnum, amax, dig_lo, dig_alpha,
            conv, conv_sh, dmod, dmod_sh, t_p, t_twp, st);
    });
}

// The CI form: t_twc / t_itwc packed in the split's order.
static int decompose_ci_launch(
        int64_t* ext, int64_t* coeff, const int64_t* c, int batch, int nl,
        int n_t, int dnum, int amax, int logn, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* qi, const int64_t* qi_sh,
        const int64_t* srcp, const float* srcq, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twc, const int64_t* t_itwc,
        const int64_t* t_ninv, const int64_t* t_ninv_sh,
        const int64_t* ci_src, const int64_t* ci_pos, cudaStream_t st) {
    return (int)with_logn(logn, [&](auto cst) {
        constexpr int LOGN = decltype(cst)::value;
        using SP = Split<LOGN>;
        // A: cluster b * nl + i transforms Q row i of poly b
        cudaError_t e = launch_split<LOGN>(
            ntt_inv_cluster<LOGN, true>, (int64_t)batch * nl, SP::SMEM_INV,
            st, coeff, c, nl, t_p, t_itwc, t_ninv, t_ninv_sh, ci_src);
        if (e != cudaSuccess) return e;
        // B
        return launch_split_grid<LOGN>(
            fbc_ntt_digits_ci<LOGN>, n_t, dnum, batch, SP::SMEM_LIFT, st,
            ext, coeff, nl, n_t, dnum, amax, dig_lo,
            dig_alpha, qi, qi_sh, srcp, srcq, conv, conv_sh, dmod, dmod_sh,
            t_p, t_twc, ci_pos);
    });
}

// ci_src, ci_pos: the CI ring's map (logn then the lift's), or both null.
// zs, zs_sh (nl): the standard form's launch A constants (n^-1 qhat_inv
// of each Q row's digit, kernels/keyswitch.py `_digit_stack`), null on the
// CI ring, whose launch A scales by t_ninv.
extern "C" int orion_ks_decompose(
        int64_t* ext, int64_t* coeff, const int64_t* c, int batch, int nl,
        int n_t, int dnum, int amax, int logn, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* qi, const int64_t* qi_sh,
        const int64_t* srcp, const float* srcq, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twp, const int64_t* t_itwp,
        const int64_t* t_ninv, const int64_t* t_ninv_sh, const int64_t* zs,
        const int64_t* zs_sh, const int64_t* ci_src, const int64_t* ci_pos,
        void* stream) {
    if (ci_pos != nullptr)
        return decompose_ci_launch(
            ext, coeff, c, batch, nl, n_t, dnum, amax, logn, dig_lo,
            dig_alpha, qi, qi_sh, srcp, srcq, conv, conv_sh, dmod, dmod_sh,
            t_p, t_twp, t_itwp, t_ninv, t_ninv_sh, ci_src, ci_pos,
            (cudaStream_t)stream);
    return decompose_launch(ext, coeff, c, batch, nl, n_t, dnum, amax, logn,
                            dig_lo, dig_alpha, qi, qi_sh, srcp, srcq, conv,
                            conv_sh, dmod, dmod_sh, t_p, t_twp, t_itwp, zs,
                            zs_sh, (cudaStream_t)stream);
}

// Launch B of orion_ks_decompose alone, standard ring only: ext (batch,
// dnum, n_t, N) from the coefficients coeff (batch, nl, N) of every Q row,
// onto the n_t rows of the tables given (conv, conv_sh (dnum, amax, n_t),
// dmod, dmod_sh (dnum, n_t), t_p (n_t), t_twp (n_t, N)).  The digits'
// zq and v come from a prologue pass over coeff (hoist_digits) into
// scratch that the caller leaves behind ext: ext's buffer holds batch *
// N * (4 nl + dnum) bytes past its batch * dnum * n_t * N words.
extern "C" int orion_ks_convert(
        int64_t* ext, const int64_t* coeff, int batch, int nl, int n_t,
        int dnum, int amax, int logn, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* qi, const int64_t* qi_sh,
        const int64_t* srcp, const float* srcq, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_twp, void* stream) {
    return (int)with_logn(logn, [&](auto cst) {
        constexpr int LOGN = decltype(cst)::value;
        constexpr int N = 1 << LOGN;
        const cudaStream_t st = (cudaStream_t)stream;
        uint32_t* zq = reinterpret_cast<uint32_t*>(
            ext + (int64_t)batch * dnum * n_t * N);
        uint8_t* vb = hoisted_v(zq, batch, nl, N);
        cudaError_t e = launch_hoist(
            zq, vb, coeff, (int64_t)nl * N, (int64_t)nl * N,
            (int64_t)dnum * N, N, dnum, batch, amax, dig_lo, dig_alpha, qi,
            qi_sh, srcp, srcq, st);
        if (e != cudaSuccess) return e;
        return convert_grid<LOGN>(
            ext, zq, vb, batch, nl, n_t, dnum, amax, dig_lo, dig_alpha,
            conv, conv_sh, dmod, dmod_sh, t_p, t_twp, st);
    });
}
