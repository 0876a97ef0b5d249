// 32-bit modular arithmetic and the shared-memory NTT used by every kernel
// of the port (orion_tpu_torch/kernels/csrc/*.cu).
//
// Residues live in device memory as int64 (the port's storage type) and
// are computed here in 32-bit unsigned registers: every prime is < 2^31,
// so a + b < 2^32 and Shoup's product needs one __umulhi.  Results are the
// exact residues, bit-identical to the plain PyTorch versions
// (orion_tpu_torch/crypto/modops.py, ntt4.py).
//
// The transform is the merged-psi negacyclic NTT of crypto/ref.py:
// Cooley-Tukey, standard order in, bit-reversed order out, twiddles
// tw[m + i] = psi^bitrev(m + i); the inverse is Gentleman-Sande with the
// bit-reversed psi^-1 table, then a Shoup multiply by n^-1.  One thread
// block holds one length-N row in shared memory (N * 4 bytes: 32 KiB at
// N = 8192) and runs the log2(N) stages with a barrier between them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace orion {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    uint32_t s = a + b;
    return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    return a >= b ? a - b : a + p - b;
}

// a * w mod p with w_sh = floor(w * 2^32 / p); exact for any a < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
    uint32_t q = __umulhi(a, w_sh);
    uint32_t r = a * w - q * p;
    return r >= p ? r - p : r;
}

// Montgomery product a * b * 2^-32 mod p, pinv = -p^-1 mod 2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
    uint32_t lo = a * b;
    uint32_t hi = __umulhi(a, b);
    uint32_t m = lo * pinv;
    uint32_t t = hi + __umulhi(m, p) + (lo != 0u ? 1u : 0u);
    return t >= p ? t - p : t;
}

// Forward NTT of the row in shared memory s[0 .. 2^logn).  The caller
// synchronises after filling s; the last stage ends with a barrier.
__device__ __forceinline__ void ntt_fwd_smem(uint32_t* s, int logn,
                                             const int64_t* tw,
                                             const int64_t* tw_sh,
                                             uint32_t p) {
    const int half = 1 << (logn - 1);
    for (int logm = 0; logm < logn; ++logm) {
        const int logt = logn - 1 - logm;
        const int tmask = (1 << logt) - 1;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int i = k >> logt;
            const int lo = (i << (logt + 1)) + (k & tmask);
            const int hi = lo + (1 << logt);
            const int wi = (1 << logm) + i;
            const uint32_t v = shoup_mul(s[hi], (uint32_t)tw[wi],
                                         (uint32_t)tw_sh[wi], p);
            const uint32_t u = s[lo];
            s[lo] = add_mod(u, v, p);
            s[hi] = sub_mod(u, v, p);
        }
        __syncthreads();
    }
}

// Inverse NTT (without the n^-1 scale) of the row in shared memory.
__device__ __forceinline__ void ntt_inv_smem(uint32_t* s, int logn,
                                             const int64_t* itw,
                                             const int64_t* itw_sh,
                                             uint32_t p) {
    const int half = 1 << (logn - 1);
    for (int logm = logn - 1; logm >= 0; --logm) {
        const int logt = logn - 1 - logm;
        const int tmask = (1 << logt) - 1;
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int i = k >> logt;
            const int lo = (i << (logt + 1)) + (k & tmask);
            const int hi = lo + (1 << logt);
            const int wi = (1 << logm) + i;
            const uint32_t u = s[lo];
            const uint32_t w = s[hi];
            s[lo] = add_mod(u, w, p);
            s[hi] = shoup_mul(sub_mod(u, w, p), (uint32_t)itw[wi],
                              (uint32_t)itw_sh[wi], p);
        }
        __syncthreads();
    }
}

// One coefficient of the approximate HPS fast basis conversion
// (crypto/keyswitch.py fbc): from the alpha source residues z[m * zstride]
// of a digit to the target prime pt.
//   zq_m = z_m * qhat_inv_m mod q_m
//   v    = round(sum_m f32(zq_m) / f32(q_m))        (IEEE float32, in order)
//   out  = sum_m zq_m * conv_m - v * dmod  mod pt
// conv[m * cstride] is [D / q_m]_pt.  The float32 sum and division must
// round as on the CPU (no fast-math), or v differs by one.
__device__ __forceinline__ uint32_t fbc_one(
        const int64_t* z, int64_t zstride, int alpha, const int64_t* qi,
        const int64_t* qi_sh, const int64_t* srcp, const float* srcq,
        const int64_t* conv, const int64_t* conv_sh, int cstride,
        uint32_t dmod, uint32_t dmod_sh, uint32_t pt) {
    float frac = 0.0f;
    uint32_t acc = 0;
    for (int m = 0; m < alpha; ++m) {
        const uint32_t zq = shoup_mul((uint32_t)z[m * zstride],
                                      (uint32_t)qi[m], (uint32_t)qi_sh[m],
                                      (uint32_t)srcp[m]);
        frac = __fadd_rn(frac, __fdiv_rn(__uint2float_rn(zq), srcq[m]));
        acc = add_mod(acc, shoup_mul(zq, (uint32_t)conv[m * cstride],
                                     (uint32_t)conv_sh[m * cstride], pt),
                      pt);
    }
    const uint32_t v = __float2uint_rn(frac);
    return sub_mod(acc, shoup_mul(v, dmod, dmod_sh, pt), pt);
}

// Row transforms: block r handles row r of a (rows, N) int64 array whose
// limb (table row) is r % L.  in and out may alias.
__global__ void ntt_fwd_rows(int64_t* out, const int64_t* in, int L,
                             int logn, const int64_t* p,
                             const int64_t* tw, const int64_t* tw_sh) {
    extern __shared__ uint32_t s[];
    const int n = 1 << logn;
    const int row = blockIdx.x;
    const int limb = row % L;
    const int64_t* src = in + (int64_t)row * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = (uint32_t)src[k];
    __syncthreads();
    ntt_fwd_smem(s, logn, tw + (int64_t)limb * n, tw_sh + (int64_t)limb * n,
                 (uint32_t)p[limb]);
    int64_t* dst = out + (int64_t)row * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = s[k];
}

__global__ void ntt_inv_rows(int64_t* out, const int64_t* in, int L,
                             int logn, const int64_t* p,
                             const int64_t* itw, const int64_t* itw_sh,
                             const int64_t* ninv, const int64_t* ninv_sh) {
    extern __shared__ uint32_t s[];
    const int n = 1 << logn;
    const int row = blockIdx.x;
    const int limb = row % L;
    const uint32_t pl = (uint32_t)p[limb];
    const int64_t* src = in + (int64_t)row * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = (uint32_t)src[k];
    __syncthreads();
    ntt_inv_smem(s, logn, itw + (int64_t)limb * n,
                 itw_sh + (int64_t)limb * n, pl);
    const uint32_t nv = (uint32_t)ninv[limb];
    const uint32_t nv_sh = (uint32_t)ninv_sh[limb];
    int64_t* dst = out + (int64_t)row * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        dst[k] = shoup_mul(s[k], nv, nv_sh, pl);
}

// Threads per block: N/2 butterflies per stage, at most 512 threads.
inline int row_threads(int logn) {
    int t = 1 << (logn - 1);
    return t < 512 ? t : 512;
}

inline size_t row_smem(int logn) { return sizeof(uint32_t) << logn; }

// Allow more than the default 48 KB of dynamic shared memory when a row
// needs it (N > 12288); a no-op at the port's ring sizes.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace orion
