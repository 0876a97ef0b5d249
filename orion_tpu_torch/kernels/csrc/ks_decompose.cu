// ks_decompose: the hoistable half of a hybrid key-switch.  c (nl, N) in
// the NTT domain -> ext (dnum, n_t, N) in the NTT domain, where digit d's
// alpha source limbs are converted to all n_t = nl + n_sp target primes.
//
// Replaces orion_tpu/crypto/ks_pallas.py ks_decompose_pallas (bodies
// _decompose_k, _fbc_k), which keeps the whole decomposition in one VMEM
// program.  Hopper's thread blocks run in no order, and the basis
// conversion of one target row reads every source limb of its digit, so
// the work is split at a launch boundary:
//   launch A: one block per Q row - inverse NTT into a coefficient scratch;
//   launch B: one block per (target row t, digit d) - the fast basis
//             conversion of the digit into shared memory, the forward NTT
//             with row t's tables, and one write of ext[d, t].
//
// What bounds it: device memory.  It reads c and writes ext once (int64),
// plus the scratch round trip and the twiddle tables; launch B re-reads
// the alpha source rows once per target row (n_t times), from L2 at the
// MLP's sizes.  The conversion and the transforms stay in registers and
// shared memory.  The grid is small at the MLP (dnum * n_t <= 24 blocks of
// 512 threads); filling the card with more rows per launch is later speed
// work.
//
// Table layouts (all contiguous int64 except srcq, float32):
//   dig_lo, dig_alpha (dnum); qi, qi_sh, srcp, srcq (dnum, amax);
//   conv, conv_sh (dnum, amax, n_t); dmod, dmod_sh (dnum, n_t);
//   t_* are the target rows' tables (Q rows 0..nl-1 first, then specials).

#include "modarith.cuh"

using namespace orion;

__global__ void fbc_ntt_digits(
        int64_t* ext, const int64_t* coeff, int n_t, int amax, int logn,
        const int64_t* dig_lo, const int64_t* dig_alpha, const int64_t* qi,
        const int64_t* qi_sh, const int64_t* srcp, const float* srcq,
        const int64_t* conv, const int64_t* conv_sh, const int64_t* dmod,
        const int64_t* dmod_sh, const int64_t* t_p, const int64_t* t_tw,
        const int64_t* t_tw_sh) {
    extern __shared__ uint32_t s[];
    const int n = 1 << logn;
    const int t = blockIdx.x;
    const int d = blockIdx.y;
    const uint32_t pt = (uint32_t)t_p[t];
    const int alpha = (int)dig_alpha[d];
    const int64_t* z = coeff + dig_lo[d] * n;
    const int64_t dg = (int64_t)d * amax;
    const int64_t* cv = conv + dg * n_t + t;
    const int64_t* cv_sh = conv_sh + dg * n_t + t;
    const uint32_t dm = (uint32_t)dmod[(int64_t)d * n_t + t];
    const uint32_t dm_sh = (uint32_t)dmod_sh[(int64_t)d * n_t + t];
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        s[k] = fbc_one(z + k, n, alpha, qi + dg, qi_sh + dg, srcp + dg,
                       srcq + dg, cv, cv_sh, n_t, dm, dm_sh, pt);
    __syncthreads();
    ntt_fwd_smem(s, logn, t_tw + (int64_t)t * n, t_tw_sh + (int64_t)t * n,
                 pt);
    int64_t* dst = ext + ((int64_t)d * n_t + t) * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = s[k];
}

extern "C" int orion_ks_decompose(
        int64_t* ext, int64_t* coeff, const int64_t* c, int nl, int n_t,
        int dnum, int amax, int logn, const int64_t* dig_lo,
        const int64_t* dig_alpha, const int64_t* qi, const int64_t* qi_sh,
        const int64_t* srcp, const float* srcq, const int64_t* conv,
        const int64_t* conv_sh, const int64_t* dmod, const int64_t* dmod_sh,
        const int64_t* t_p, const int64_t* t_tw, const int64_t* t_tw_sh,
        const int64_t* t_itw, const int64_t* t_itw_sh, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, void* stream) {
    const size_t smem = row_smem(logn);
    const int threads = row_threads(logn);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = allow_smem(ntt_inv_rows, smem);
    if (e == cudaSuccess) e = allow_smem(fbc_ntt_digits, smem);
    if (e != cudaSuccess) return (int)e;
    // A: the Q rows are the first nl rows of the target tables
    ntt_inv_rows<<<nl, threads, smem, st>>>(coeff, c, nl, logn, t_p, t_itw,
                                            t_itw_sh, t_ninv, t_ninv_sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // B
    fbc_ntt_digits<<<dim3(n_t, dnum), threads, smem, st>>>(
        ext, coeff, n_t, amax, logn, dig_lo, dig_alpha, qi, qi_sh, srcp,
        srcq, conv, conv_sh, dmod, dmod_sh, t_p, t_tw, t_tw_sh);
    return (int)cudaGetLastError();
}
