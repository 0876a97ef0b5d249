// The fast basis conversion with its digit-invariant half hoisted (the
// standard ring's ks_decompose.cu and ks_finish.cu, and ntt.cu's
// mod_drop_rescale, whose one digit is the divisor rows [specials..., q_l]).
//
// fbc_one (modarith.cuh) converts the alpha source residues z_m of one
// coefficient to one target prime pt: zq_m = z_m * qhat_inv_m mod q_m,
// v = round(sum_m f32(zq_m) / f32(q_m)), out = sum_m zq_m * conv_m - v *
// dmod mod pt.  Only the last sum depends on the target.  A key-switch
// converts every coefficient to n_t targets (ks_decompose: 50 rows at
// configs/resnet.yml's level 43) or nl (ModDown: 44), so computing zq and
// v there once per target repeated a Shoup product, an IEEE division and
// a float add per source residue n_t times.  Here they are computed once:
//   - zq as uint32, one word per source coefficient, stored by the inverse
//     transform that produces the coefficient (its n^-1 scale and qhat_inv
//     folded into one Shoup constant, so the store costs what the scale
//     did);
//   - v as one byte per (digit, coefficient), v <= alpha <= MAX_ALPHA, by
//     hoist_digits, a pass of one thread per (coefficient, digit, poly)
//     between the inverse transforms and the target loops: a digit's alpha
//     rows come from alpha transforms that run in no order, so their
//     quotients meet at a launch boundary;
// and the target loops (fbc_target) do alpha Shoup products, alpha
// modular adds and one Shoup product for v * dmod.  v is the float32 sum
// of fbc_quot in source order from 0.0f, rounded by __float2uint_rn, so it
// is fbc_one's (and the CPU's) bit for bit.  The limb-sharded entries,
// whose source rows arrive as int64 coefficients, run hoist_digits on
// them, zq included.
//
// (A first design summed the quotients inside the inverse transforms'
// launch, the blocks of one digit a thread-block cluster exchanging them
// through distributed shared memory.  On the H100 the batched calls ran
// slower than without the hoist: clusters of 4-6 CTAs of 1024 threads
// left SMs of each GPC idle, and the inverse's extra registers halved its
// blocks per SM.)
#pragma once

#include "cluster_ntt.cuh"

namespace orion {

// The most source rows of one digit (alpha, or ModDown's special primes)
// the target loops take: they unroll over it.
constexpr int MAX_ALPHA = 8;

// A digit's conversion constants onto one target, packed conv | conv_sh
// << 32, into shared memory cw[m] (m < alpha) by the block's first
// threads; the caller synchronises before the reads.  (In registers they
// took 16 more of each thread's 64 at 1024 threads and spilled at LogN
// 14; a warp reads one word at a time, a broadcast.)
constexpr size_t CONV_SMEM = sizeof(u64) * MAX_ALPHA;

__device__ __forceinline__ void stage_conv(u64* cw, const int64_t* conv,
                                           const int64_t* conv_sh,
                                           int64_t stride, int alpha) {
    const int m = (int)threadIdx.x;
    if (m < alpha)
        cw[m] = (u64)(uint32_t)conv[m * stride]
                | (u64)(uint32_t)conv_sh[m * stride] << 32;
}

// The target half of one coefficient's conversion: sum_m zq[m * zstride] *
// conv_m - v * dmod mod pt, from the hoisted zq (uint32) and v, the
// constants staged in cw.  NC reads zq through the read-only path
// (__ldg), which holds only for data that no grid writes while the
// kernel runs: a programmatic dependent that reads the zq of the grid
// ahead of it (ntt.cu's drop_lift_ntt) passes false and loads zq cached
// in L2 only (__ldcg, ld.global.cg: coherent with the grid ahead's
// stores once griddepcontrol.wait returned; plain loads made it slower:
// PERF.md, Findings).
template <bool NC = true>
__device__ __forceinline__ uint32_t fbc_target(
        const uint32_t* zq, int64_t zstride, uint32_t v, int alpha,
        const u64* cw, uint32_t dmod, uint32_t dmod_sh, uint32_t pt) {
    uint32_t z[MAX_ALPHA];
#pragma unroll
    for (int m = 0; m < MAX_ALPHA; ++m)
        z[m] = m >= alpha ? 0u : NC ? __ldg(zq + m * zstride)
                                    : __ldcg(zq + m * zstride);
    uint32_t acc = 0;
#pragma unroll
    for (int m = 0; m < MAX_ALPHA; ++m)
        if (m < alpha) acc = add_mod(acc, shoup_mul(z[m], cw[m], pt), pt);
    return sub_mod(acc, shoup_mul(v, dmod, dmod_sh, pt), pt);
}

// A row's target half into the transform's shared memory s (Ring<LOGN>'s
// padded layout): coefficient i = threadIdx.x + k * T, k < R, from zq
// (its rows zstride apart) and v; the caller synchronises before the
// transform reads s.  Converting apart from the transform's first pass
// keeps the two from holding registers at once.
template <int LOGN>
__device__ __forceinline__ void hoist_target(
        uint32_t* s, const uint32_t* zq, int64_t zstride, const uint8_t* v,
        int alpha, const u64* cw, uint32_t dmod, uint32_t dmod_sh,
        uint32_t pt) {
    using RG = Ring<LOGN>;
#pragma unroll 1
    for (int k = 0; k < RG::R; ++k) {
        const int i = (int)threadIdx.x + k * RG::T;
        s[pad(i)] = fbc_target(zq + i, zstride, __ldg(v + i), alpha, cw,
                               dmod, dmod_sh, pt);
    }
}

// Blocks per SM that the single-block kernels of the standard key-switch
// (fbc_ntt_digits, ks_inner_intt, moddown_rows) ask ptxas to fit in their
// __launch_bounds__: two blocks of 1024 threads up to LogN 13, at 32
// registers a thread, where one block of 44-56 registers left half the
// SM's warps idle (the batched calls ran faster at two: PERF.md, Findings);
// one at LogN 14 (R = 16 residues a thread).  To fit 32 registers the target
// loops convert into shared memory before the transform (hoist_target).
template <int LOGN>
constexpr int ks_min_blocks() { return Ring<LOGN>::R <= 8 ? 2 : 1; }

// The hoisted half, one thread per (coefficient, digit, poly): grid
// (n / HOIST_T, digits, polys).  Digit d has source rows lo_d .. lo_d +
// alpha_d - 1 (dig_lo / dig_alpha null: one digit of `amax` rows from row
// 0), poly b's row r at zq + b * zq_poly + r * n (uint32).  With src
// null, zq holds the rows already (an inverse transform stored them);
// otherwise src holds them as int64 coefficients (poly b's row r at src +
// b * src_poly + r * n) and zq = z * qhat_inv mod q is stored first.  v of
// digit d goes to vb + b * v_poly + d * n.  qi, qi_sh, srcp, srcq
// (digits, amax).  It waits for the grid ahead before it reads: ntt.cu's
// drop launches it as the programmatic dependent of the kernel that
// stores zq (an ordinary launch's wait returns at once); its own
// dependent starts as it ends (an early trigger here made back-to-back
// drops 2-9 us slower: PERF.md, Findings).
constexpr int HOIST_T = 256;  // threads per block

__global__ void __launch_bounds__(HOIST_T) hoist_digits(
        uint32_t* zq, uint8_t* vb, const int64_t* src, int64_t src_poly,
        int64_t zq_poly, int64_t v_poly, int n, int amax,
        const int64_t* dig_lo, const int64_t* dig_alpha, const int64_t* qi,
        const int64_t* qi_sh, const int64_t* srcp, const float* srcq) {
    grid_dependency_wait();
    const int c = (int)(blockIdx.x * HOIST_T + threadIdx.x);
    const int d = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t lo = dig_lo == nullptr ? 0 : dig_lo[d];
    const int alpha = dig_alpha == nullptr ? amax : (int)dig_alpha[d];
    const int64_t dg = (int64_t)d * amax;
    uint32_t* dz = zq + b * zq_poly + lo * n + c;
    // every row's residue loaded before the sum, which runs in order
    uint32_t q[MAX_ALPHA];
    if (src == nullptr) {
#pragma unroll
        for (int m = 0; m < MAX_ALPHA; ++m)
            q[m] = m < alpha ? dz[(int64_t)m * n] : 0u;
    } else {
        const int64_t* z = src + b * src_poly + lo * n + c;
#pragma unroll
        for (int m = 0; m < MAX_ALPHA; ++m)
            q[m] = m < alpha ? (uint32_t)z[(int64_t)m * n] : 0u;
#pragma unroll
        for (int m = 0; m < MAX_ALPHA; ++m)
            if (m < alpha) {
                q[m] = shoup_mul(q[m], (uint32_t)qi[dg + m],
                                 (uint32_t)qi_sh[dg + m],
                                 (uint32_t)srcp[dg + m]);
                dz[(int64_t)m * n] = q[m];
            }
    }
    float frac = 0.0f;
#pragma unroll
    for (int m = 0; m < MAX_ALPHA; ++m)
        if (m < alpha) frac = __fadd_rn(frac, fbc_quot(q[m], srcq[dg + m]));
    vb[b * v_poly + (int64_t)d * n + c] = (uint8_t)__float2uint_rn(frac);
}

// Launch hoist_digits (see above) over `digits` digits of `polys` polys;
// with pdl as the programmatic dependent of the kernel ahead of it.
inline cudaError_t launch_hoist(
        uint32_t* zq, uint8_t* vb, const int64_t* src, int64_t src_poly,
        int64_t zq_poly, int64_t v_poly, int n, int digits, int polys,
        int amax, const int64_t* dig_lo, const int64_t* dig_alpha,
        const int64_t* qi, const int64_t* qi_sh, const int64_t* srcp,
        const float* srcq, cudaStream_t st, bool pdl = false) {
    if (n % HOIST_T || digits < 1 || digits > 65535 || polys < 1
        || polys > 65535 || amax < 1 || amax > MAX_ALPHA)
        return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n / HOIST_T, digits, polys);
    cfg.blockDim = dim3(HOIST_T);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = pdl ? 1 : 0;
    cudaError_t e = cudaLaunchKernelEx(&cfg, hoist_digits, zq, vb, src,
                                       src_poly, zq_poly, v_poly, n, amax,
                                       dig_lo, dig_alpha, qi, qi_sh, srcp,
                                       srcq);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace orion
