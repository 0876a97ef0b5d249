// ntt_fwd / ntt_inv: negacyclic NTT and inverse NTT of (rows, N) int64
// residues, one thread block per row.
//
// Replaces orion_tpu/crypto/ks_pallas.py pallas_ntt4 (body _kntt) and
// pallas_intt4 (body _kintt), which run the four-step transform on an
// (R, 128) VMEM tile with rolls and selects.  Hopper has no such layout
// constraint: a row fits one block, whose threads hold it in registers and
// exchange it through shared memory between passes of up to three radix-2
// stages (the core in modarith.cuh).  Output order equals ntt4's
// (bit-reversed).
//
// What bounds it: device memory.  Per row it reads N int64 residues and
// writes N, and reads the row's packed twiddle table (N words); the
// 13 * N/2 Shoup butterflies at N = 8192 are ~4 integer multiplies each,
// far below the card's integer rate.  Each residue crosses device memory
// once each way.  The launch is still one block per row, so a call with
// few rows leaves most SMs idle; its time is the latency of one block.
//
// C interface (ctypes): pointers to contiguous int64 device arrays, the
// CUDA stream as an opaque pointer; returns the cudaError_t of the launch.

#include "modarith.cuh"

using namespace orion;

extern "C" int orion_ntt_fwd(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* twp, void* stream) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        using RG = Ring<LOGN>;
        cudaError_t e = allow_smem(ntt_fwd_rows<LOGN>, RG::SMEM);
        if (e != cudaSuccess) return e;
        ntt_fwd_rows<LOGN><<<rows, RG::T, RG::SMEM, (cudaStream_t)stream>>>(
            out, in, L, p, twp);
        return cudaGetLastError();
    });
}

extern "C" int orion_ntt_inv(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* itwp, const int64_t* ninv,
                             const int64_t* ninv_sh, void* stream) {
    return (int)with_logn(logn, [&](auto c) {
        constexpr int LOGN = decltype(c)::value;
        using RG = Ring<LOGN>;
        cudaError_t e = allow_smem(ntt_inv_rows<LOGN>, RG::SMEM);
        if (e != cudaSuccess) return e;
        ntt_inv_rows<LOGN><<<rows, RG::T, RG::SMEM, (cudaStream_t)stream>>>(
            out, in, L, p, itwp, ninv, ninv_sh);
        return cudaGetLastError();
    });
}
