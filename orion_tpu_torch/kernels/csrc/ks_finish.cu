// ks_finish: the key inner product and ModDown of a hybrid key-switch.
// ext (dnum, n_t, N) and a key-switch key -> (2, nl, N), NTT domain.
//
// Replaces orion_tpu/crypto/ks_pallas.py ks_finish_pallas (body
// _finish_k, single-shot in VMEM) and ks_finish_pallas_grid (the same over
// a (digit, poly) grid that streams the key when it exceeds VMEM).  The
// TPU split exists only for VMEM's budget; Hopper has none, so one design
// covers every level:
//   launch A: one block per (extended row t, poly q) - sum_j ext[j, t] *
//             ksk[j, q, row(t)] mod p_t (Shoup companions, or a Montgomery
//             lift when the key is lean); Q rows are stored to the work
//             buffer as they are, special rows get their inverse NTT in
//             shared memory first;
//   launch B: one block per (Q row i, poly q) - the fast basis conversion
//             of the special rows to q_i, the forward NTT, then
//             (acc_q - lift) * P^-1 mod q_i.
// The conversion reads every special row of its poly, which is why the two
// halves meet at a launch boundary (blocks run in no order).
//
// Keys: trimmed (dnum, 2, n_t, N) or full-chain (dnum_full, 2, n_all, N);
// row_map[t] gives the key row of extended row t and krows the key's row
// count, so both layouts are read in place without a gather.
//
// What bounds it: device memory.  The key dominates the bytes: 2 * dnum *
// n_t * N int64 words, twice that with Shoup companions, each read once;
// ext is read once per poly.  The work buffer (2, n_t, N) makes one round
// trip.  Everything else stays in registers and shared memory.

#include "modarith.cuh"

using namespace orion;

__global__ void ks_inner_intt(
        int64_t* work, const int64_t* ext, const int64_t* ksk,
        const int64_t* ksk_sh, const int64_t* row_map, int krows, int nl,
        int n_t, int dnum, int logn, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_itw, const int64_t* t_itw_sh, const int64_t* t_ninv,
        const int64_t* t_ninv_sh) {
    extern __shared__ uint32_t s[];
    const int n = 1 << logn;
    const int t = blockIdx.x;
    const int q = blockIdx.y;
    const uint32_t p = (uint32_t)t_p[t];
    const int64_t row = row_map[t];
    const bool lean = ksk_sh == nullptr;
    const uint32_t pinv = (uint32_t)t_pinv[t];
    const uint32_t rm = (uint32_t)t_rmod[t];
    const uint32_t rsh = (uint32_t)t_rsh[t];
    const bool special = t >= nl;
    int64_t* dst = work + ((int64_t)q * n_t + t) * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        uint32_t acc = 0;
        for (int j = 0; j < dnum; ++j) {
            const uint32_t e = (uint32_t)ext[((int64_t)j * n_t + t) * n + k];
            const int64_t ki = (((int64_t)j * 2 + q) * krows + row) * n + k;
            const uint32_t key = (uint32_t)ksk[ki];
            const uint32_t term =
                lean ? mont_mul(e, shoup_mul(key, rm, rsh, p), p, pinv)
                     : shoup_mul(e, key, (uint32_t)ksk_sh[ki], p);
            acc = add_mod(acc, term, p);
        }
        if (special) s[k] = acc;
        else dst[k] = acc;
    }
    if (!special) return;  // uniform per block
    __syncthreads();
    ntt_inv_smem(s, logn, t_itw + (int64_t)t * n, t_itw_sh + (int64_t)t * n,
                 p);
    const uint32_t nv = (uint32_t)t_ninv[t];
    const uint32_t nv_sh = (uint32_t)t_ninv_sh[t];
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        dst[k] = shoup_mul(s[k], nv, nv_sh, p);
}

__global__ void moddown_rows(
        int64_t* out, const int64_t* work, int nl, int n_t, int n_sp,
        int logn, const int64_t* md_qi, const int64_t* md_qi_sh,
        const int64_t* md_srcp, const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, const int64_t* t_p, const int64_t* t_tw,
        const int64_t* t_tw_sh) {
    extern __shared__ uint32_t s[];
    const int n = 1 << logn;
    const int i = blockIdx.x;
    const int q = blockIdx.y;
    const uint32_t p = (uint32_t)t_p[i];
    const int64_t* poly = work + (int64_t)q * n_t * n;
    const int64_t* sp = poly + (int64_t)nl * n;
    const uint32_t dm = (uint32_t)md_dmod[i];
    const uint32_t dm_sh = (uint32_t)md_dmod_sh[i];
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        s[k] = fbc_one(sp + k, n, n_sp, md_qi, md_qi_sh, md_srcp, md_srcq,
                       md_conv + i, md_conv_sh + i, nl, dm, dm_sh, p);
    __syncthreads();
    ntt_fwd_smem(s, logn, t_tw + (int64_t)i * n, t_tw_sh + (int64_t)i * n,
                 p);
    const uint32_t pv = (uint32_t)pinv_q[i];
    const uint32_t pv_sh = (uint32_t)pinv_q_sh[i];
    const int64_t* qrow = poly + (int64_t)i * n;
    int64_t* dst = out + ((int64_t)q * nl + i) * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        dst[k] = shoup_mul(sub_mod((uint32_t)qrow[k], s[k], p), pv, pv_sh,
                           p);
}

extern "C" int orion_ks_finish(
        int64_t* out, int64_t* work, const int64_t* ext, const int64_t* ksk,
        const int64_t* ksk_sh, const int64_t* row_map, int krows, int nl,
        int n_t, int dnum, int logn, const int64_t* t_p,
        const int64_t* t_pinv, const int64_t* t_rmod, const int64_t* t_rsh,
        const int64_t* t_tw, const int64_t* t_tw_sh, const int64_t* t_itw,
        const int64_t* t_itw_sh, const int64_t* t_ninv,
        const int64_t* t_ninv_sh, const int64_t* md_qi,
        const int64_t* md_qi_sh, const int64_t* md_srcp,
        const float* md_srcq, const int64_t* md_conv,
        const int64_t* md_conv_sh, const int64_t* md_dmod,
        const int64_t* md_dmod_sh, const int64_t* pinv_q,
        const int64_t* pinv_q_sh, void* stream) {
    const size_t smem = row_smem(logn);
    const int threads = row_threads(logn);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = allow_smem(ks_inner_intt, smem);
    if (e == cudaSuccess) e = allow_smem(moddown_rows, smem);
    if (e != cudaSuccess) return (int)e;
    ks_inner_intt<<<dim3(n_t, 2), threads, smem, st>>>(
        work, ext, ksk, ksk_sh, row_map, krows, nl, n_t, dnum, logn, t_p,
        t_pinv, t_rmod, t_rsh, t_itw, t_itw_sh, t_ninv, t_ninv_sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    moddown_rows<<<dim3(nl, 2), threads, smem, st>>>(
        out, work, nl, n_t, n_t - nl, logn, md_qi, md_qi_sh, md_srcp,
        md_srcq, md_conv, md_conv_sh, md_dmod, md_dmod_sh, pinv_q, pinv_q_sh,
        t_p, t_tw, t_tw_sh);
    return (int)cudaGetLastError();
}
