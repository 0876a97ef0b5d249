// ntt_fwd / ntt_inv: negacyclic NTT and inverse NTT of (rows, N) int64
// residues, one thread block per row.
//
// Replaces orion_tpu/crypto/ks_pallas.py pallas_ntt4 (body _kntt) and
// pallas_intt4 (body _kintt), which run the four-step transform on an
// (R, 128) VMEM tile with rolls and selects.  Hopper has no such layout
// constraint: a LogN-13 row is 32 KiB of uint32 and fits one block's
// shared memory, so the plain radix-2 stage loop runs there with a barrier
// per stage (modarith.cuh).  Output order equals ntt4's (bit-reversed).
//
// What bounds it: device memory.  Per row it reads N int64 residues and
// writes N, and reads the row's twiddle and Shoup tables (2 N int64); the
// 13 * N/2 Shoup butterflies at N = 8192 are ~4 integer multiplies each,
// far below the card's integer rate.  The design keeps every intermediate
// stage in shared memory, so each residue crosses device memory once each
// way; the twiddles are read once per stage from L2.
//
// C interface (ctypes): pointers to contiguous int64 device arrays, the
// CUDA stream as an opaque pointer; returns the cudaError_t of the launch.

#include "modarith.cuh"

using namespace orion;

extern "C" int orion_ntt_fwd(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* tw, const int64_t* tw_sh,
                             void* stream) {
    const size_t smem = row_smem(logn);
    cudaError_t e = allow_smem(ntt_fwd_rows, smem);
    if (e != cudaSuccess) return (int)e;
    ntt_fwd_rows<<<rows, row_threads(logn), smem, (cudaStream_t)stream>>>(
        out, in, L, logn, p, tw, tw_sh);
    return (int)cudaGetLastError();
}

extern "C" int orion_ntt_inv(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* itw, const int64_t* itw_sh,
                             const int64_t* ninv, const int64_t* ninv_sh,
                             void* stream) {
    const size_t smem = row_smem(logn);
    cudaError_t e = allow_smem(ntt_inv_rows, smem);
    if (e != cudaSuccess) return (int)e;
    ntt_inv_rows<<<rows, row_threads(logn), smem, (cudaStream_t)stream>>>(
        out, in, L, logn, p, itw, itw_sh, ninv, ninv_sh);
    return (int)cudaGetLastError();
}
