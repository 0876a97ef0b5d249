// 32-bit modular arithmetic and the register-resident NTT core used by
// every kernel of the port (orion_tpu_torch/kernels/csrc/*.cu).
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
// bit-reversed psi^-1 table (the caller scales by n^-1).  Modular results
// are unique, so the output equals ntt4's residue for residue.
//
// Design (Hopper): one thread block transforms one length-N row with
// T = N / R threads, each holding R residues in registers (R = 8 up to
// LogN 13, 16 at LogN 14: 1024 threads).  The log2(N) radix-2 stages are
// cut into passes of at most log2(R) stages.  In a pass, each thread loads
// groups of 2^S residues that only butterfly among themselves over the
// pass's S stages, runs those stages in registers, and writes them back;
// passes exchange through shared memory with one barrier between them
// (LogN 13: passes of 1, 3, 3, 3 and 3 stages, 4 barriers, where a stage
// loop needs 13).  R = 8 beat R = 16 (512 threads, 3 barriers) on the
// H100 in every single and batched case: a block is latency-bound, and
// twice the warps hide more of it than fewer barriers save.  The
// first pass reads its input through a caller's functor, coalesced, and
// the last one hands its output to another, so neither touches shared
// memory.  Shared memory is padded by one word per 32 (`pad`): at LogN 13
// one pass of five has 4-way bank conflicts, the others none.
//
// Twiddles come packed, w | w_shoup << 32 in one 8-byte word, reordered
// so that the 2^S - 1 twiddles of one group of one pass are contiguous
// (kernels/ntt.py `pack_twiddles` builds the tables).  For the pass over
// stages [A, A + S) and the group with high index `hi`, stage A + u reads
// packed[2^A + hi * (2^S - 1) + 2^u - 1 + m], m < 2^u, which holds
// tw[2^(A+u) + hi * 2^u + m].
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace orion {

using u64 = unsigned long long;  // a packed twiddle (for __ldg)

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

// Shoup product with a packed twiddle w | w_sh << 32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, u64 wp,
                                              uint32_t p) {
    return shoup_mul(a, (uint32_t)wp, (uint32_t)(wp >> 32), p);
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

// ------------------------------------------------------------------ //
//  The transform core                                                //
// ------------------------------------------------------------------ //

template <int LOGN>
struct Ring {
    static constexpr int N = 1 << LOGN;
    static constexpr int LOGR = LOGN >= 14 ? 4 : 3;
    static constexpr int R = 1 << LOGR;          // residues per thread
    static constexpr int T = N / R;              // threads per block
    static constexpr int PASSES = (LOGN + LOGR - 1) / LOGR;
    static constexpr int S0 = LOGN - LOGR * (PASSES - 1);  // first pass
    static constexpr size_t SMEM = sizeof(uint32_t) * (N + N / 32);
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Element j of the k-th group a thread holds in the pass over stages
// [A, A + S): groups q = tid + k * T, elements base(q) + j * 2^(LOGN-A-S).
template <int LOGN, int A, int S>
__device__ __forceinline__ int pass_elem(int k, int j) {
    constexpr int LG = LOGN - A - S;
    const int q = (int)threadIdx.x + k * Ring<LOGN>::T;
    return ((q >> LG) << (LOGN - A)) + (q & ((1 << LG) - 1)) + (j << LG);
}

// The output of the forward's last pass that this thread holds in
// register `slot` < R (its store(i, slot, v) call, `store_at`).
template <int LOGN>
__device__ __forceinline__ int fwd_out_elem(int slot) {
    using RG = Ring<LOGN>;
    constexpr int S = RG::PASSES == 1 ? RG::S0 : RG::LOGR;
    return pass_elem<LOGN, LOGN - S, S>(slot >> S, slot & ((1 << S) - 1));
}

// A forward's store functor takes output i as store(i, v), or as
// store(i, slot, v) with the register slot that held it: a constant once
// the passes are unrolled, so a caller can fetch what each output needs
// into registers before the transform (rescale_lift_ntt).
template <class Store>
__device__ __forceinline__ void store_at(Store& store, int i, int slot,
                                         uint32_t v) {
    if constexpr (std::is_invocable_v<Store&, int, int, uint32_t>)
        store(i, slot, v);
    else
        store(i, v);
}

template <int LOGN, int A, int S>
__device__ __forceinline__ const u64* pass_tw(const u64* twp, int k) {
    const int q = (int)threadIdx.x + k * Ring<LOGN>::T;
    return twp + (1 << A) + (q >> (LOGN - A - S)) * ((1 << S) - 1);
}

// Cooley-Tukey stages [A, A + S) on the registers x (R / 2^S groups).
template <int LOGN, int A, int S>
__device__ __forceinline__ void ct_stages(uint32_t* x, const u64* twp,
                                          uint32_t p) {
#pragma unroll
    for (int k = 0; k < (Ring<LOGN>::R >> S); ++k) {
        const u64* w = pass_tw<LOGN, A, S>(twp, k);
        uint32_t* r = x + (k << S);
#pragma unroll
        for (int u = 0; u < S; ++u) {
            const int hs = 1 << (S - 1 - u);
#pragma unroll
            for (int j = 0; j < (1 << S); ++j) {
                if (j & hs) continue;
                const u64 wp = __ldg(w + (1 << u) - 1 + (j >> (S - u)));
                const uint32_t v = shoup_mul(r[j + hs], wp, p);
                const uint32_t a = r[j];
                r[j] = add_mod(a, v, p);
                r[j + hs] = sub_mod(a, v, p);
            }
        }
    }
}

// Gentleman-Sande stages [A, A + S), last stage first.
template <int LOGN, int A, int S>
__device__ __forceinline__ void gs_stages(uint32_t* x, const u64* twp,
                                          uint32_t p) {
#pragma unroll
    for (int k = 0; k < (Ring<LOGN>::R >> S); ++k) {
        const u64* w = pass_tw<LOGN, A, S>(twp, k);
        uint32_t* r = x + (k << S);
#pragma unroll
        for (int u = S - 1; u >= 0; --u) {
            const int hs = 1 << (S - 1 - u);
#pragma unroll
            for (int j = 0; j < (1 << S); ++j) {
                if (j & hs) continue;
                const u64 wp = __ldg(w + (1 << u) - 1 + (j >> (S - u)));
                const uint32_t a = r[j];
                const uint32_t b = r[j + hs];
                r[j] = add_mod(a, b, p);
                r[j + hs] = shoup_mul(sub_mod(a, b, p), wp, p);
            }
        }
    }
}

// The forward passes from stage A on.  Pass 0 reads load(i); the last
// pass calls store(i, v); the others go through shared memory s.
template <int LOGN, int A, class Load, class Store>
__device__ __forceinline__ void fwd_passes(uint32_t* s, const u64* twp,
                                           uint32_t p, Load& load,
                                           Store& store) {
    using RG = Ring<LOGN>;
    constexpr int S = A == 0 ? RG::S0 : RG::LOGR;
    constexpr bool last = A + S == LOGN;
    uint32_t x[RG::R];
#pragma unroll
    for (int k = 0; k < (RG::R >> S); ++k)
#pragma unroll
        for (int j = 0; j < (1 << S); ++j) {
            const int i = pass_elem<LOGN, A, S>(k, j);
            x[(k << S) + j] = A == 0 ? load(i) : s[pad(i)];
        }
    ct_stages<LOGN, A, S>(x, twp, p);
#pragma unroll
    for (int k = 0; k < (RG::R >> S); ++k)
#pragma unroll
        for (int j = 0; j < (1 << S); ++j) {
            const int i = pass_elem<LOGN, A, S>(k, j);
            if (last) store_at(store, i, (k << S) + j, x[(k << S) + j]);
            else s[pad(i)] = x[(k << S) + j];
        }
    if constexpr (!last) {
        __syncthreads();
        fwd_passes<LOGN, A + S>(s, twp, p, load, store);
    }
}

// Nothing: the default of inv_passes' `last`.
struct NoHook {
    __device__ __forceinline__ void operator()() const {}
};

// The inverse passes from the pass that starts at stage A down to stage 0.
// The last pass calls last() after its butterflies, before its first
// store (cluster_ntt.cuh's early-arriving inverse waits there).
template <int LOGN, int A, class Load, class Store, class Last = NoHook>
__device__ __forceinline__ void inv_passes(uint32_t* s, const u64* twp,
                                           uint32_t p, Load& load,
                                           Store& store, Last last = {}) {
    using RG = Ring<LOGN>;
    constexpr int S = A == 0 ? RG::S0 : RG::LOGR;
    constexpr bool first = A + S == LOGN;
    uint32_t x[RG::R];
#pragma unroll
    for (int k = 0; k < (RG::R >> S); ++k)
#pragma unroll
        for (int j = 0; j < (1 << S); ++j) {
            const int i = pass_elem<LOGN, A, S>(k, j);
            x[(k << S) + j] = first ? load(i) : s[pad(i)];
        }
    gs_stages<LOGN, A, S>(x, twp, p);
    if constexpr (A == 0) last();
#pragma unroll
    for (int k = 0; k < (RG::R >> S); ++k)
#pragma unroll
        for (int j = 0; j < (1 << S); ++j) {
            const int i = pass_elem<LOGN, A, S>(k, j);
            if (A == 0) store(i, x[(k << S) + j]);
            else s[pad(i)] = x[(k << S) + j];
        }
    if constexpr (A != 0) {
        __syncthreads();
        inv_passes<LOGN, (A == RG::S0 ? 0 : A - RG::LOGR)>(s, twp, p, load,
                                                           store, last);
    }
}

// Forward NTT of one row: load(i) -> uint32 input i (called once per i,
// consecutive threads on consecutive i); store(i, v) takes output i.
// s: Ring<LOGN>::SMEM bytes of shared memory.  No barrier is needed
// before the call; the caller synchronises before reusing s.
template <int LOGN, class Load, class Store>
__device__ __forceinline__ void ntt_fwd_row(uint32_t* s, const int64_t* twp,
                                            uint32_t p, Load load,
                                            Store store) {
    fwd_passes<LOGN, 0>(s, reinterpret_cast<const u64*>(twp), p, load,
                        store);
}

// Inverse NTT (without the n^-1 scale): load(i) is called by each thread
// for R / 2^LOGR runs of consecutive i; store(i, v) on consecutive i
// across threads.  load may read s itself if the caller filled it (with
// `pad`) and synchronised.
template <int LOGN, class Load, class Store>
__device__ __forceinline__ void ntt_inv_row(uint32_t* s, const int64_t* itwp,
                                            uint32_t p, Load load,
                                            Store store) {
    using RG = Ring<LOGN>;
    inv_passes<LOGN, LOGN - RG::LOGR>(
        s, reinterpret_cast<const u64*>(itwp), p, load, store);
}

// The float32 quotient f32(zq) / f32(q) of one source residue zq = z *
// qhat_inv mod q: the fast basis conversion's v = round(sum_m quotient_m)
// adds these in source order m = 0, 1, ... with __fadd_rn from 0.0f and
// rounds with __float2uint_rn.  Division, sum and rounding must round as
// IEEE float32 does on the CPU (no fast-math), or v differs by one; every
// kernel forms v from this function in that order (fbc_one here, the
// hoisted conversion of hoist.cuh).
__device__ __forceinline__ float fbc_quot(uint32_t zq, float q) {
    return __fdiv_rn(__uint2float_rn(zq), q);
}

// One coefficient of the approximate HPS fast basis conversion
// (crypto/keyswitch.py fbc): from the alpha source residues z[m * zstride]
// of a digit to the target prime pt.
//   zq_m = z_m * qhat_inv_m mod q_m
//   v    = round(sum_m f32(zq_m) / f32(q_m))        (IEEE float32, in order)
//   out  = sum_m zq_m * conv_m - v * dmod  mod pt
// conv[m * cstride] is [D / q_m]_pt.  z holds int64 residues or a kernel's
// uint32 scratch.  The ConjugateInvariant forms call this once per
// coefficient and target; the standard ring's key-switch kernels compute
// the target-invariant zq and v once per coefficient instead (hoist.cuh).
template <class Z>
__device__ __forceinline__ uint32_t fbc_one(
        const Z* z, int64_t zstride, int alpha, const int64_t* qi,
        const int64_t* qi_sh, const int64_t* srcp, const float* srcq,
        const int64_t* conv, const int64_t* conv_sh, int cstride,
        uint32_t dmod, uint32_t dmod_sh, uint32_t pt) {
    float frac = 0.0f;
    uint32_t acc = 0;
    for (int m = 0; m < alpha; ++m) {
        const uint32_t zq = shoup_mul((uint32_t)z[m * zstride],
                                      (uint32_t)qi[m], (uint32_t)qi_sh[m],
                                      (uint32_t)srcp[m]);
        frac = __fadd_rn(frac, fbc_quot(zq, srcq[m]));
        acc = add_mod(acc, shoup_mul(zq, (uint32_t)conv[m * cstride],
                                     (uint32_t)conv_sh[m * cstride], pt),
                      pt);
    }
    const uint32_t v = __float2uint_rn(frac);
    return sub_mod(acc, shoup_mul(v, dmod, dmod_sh, pt), pt);
}

// ------------------------------------------------------------------ //
//  The ConjugateInvariant ring's map                                 //
// ------------------------------------------------------------------ //
//
// On the CI ring of degree n a row stores n residues, and every transform
// runs at N = 2n on the antisymmetric lift (crypto/ntt.py):
//   forward: input i of the 2n transform is a_i (i < n), 0 (i = n), or
//            -a_{2n-i} mod p (i > n), 0 staying 0; of its outputs only the
//            n orbit positions are kept, output g going to CI slot pos[g]
//            (pos[g] = -1: dropped);
//   inverse: input g is CI slot src[g]; of its outputs the first n are
//            kept.
// A kernel instantiated with CI = true applies the map in its load and
// store functors; the standard ring's kernels (CI = false) are unchanged.
// The key-switch kernels' CI forms convert each coefficient once and form
// its mirror by negation (cluster_ntt.cuh `ntt_fwd_lift`).

// Stored residues per row: N, or n = N / 2 on the CI ring.
template <int LOGN, bool CI>
__host__ __device__ constexpr int row_width() {
    return CI ? (1 << LOGN) / 2 : 1 << LOGN;
}

// -t mod p, 0 staying 0: the lift's mirror of a residue t < p.
__device__ __forceinline__ uint32_t neg_mod(uint32_t t, uint32_t p) {
    return t == 0u ? 0u : p - t;
}

// Input i of the forward transform: at(i) on the standard ring, the
// antisymmetric lift of the n values at(k) on the CI ring.
template <bool CI, class At>
__device__ __forceinline__ uint32_t lift_at(At at, int i, int n,
                                            uint32_t p) {
    if constexpr (CI) {
        if (i < n) return at(i);
        if (i == n) return 0u;
        return neg_mod(at(2 * n - i), p);
    } else {
        return at(i);
    }
}

// Output g of the forward transform: put(g) on the standard ring, put(j)
// for the CI slot j = pos[g] it holds on the CI ring, or nothing.
template <bool CI, class Put>
__device__ __forceinline__ void keep_at(const int64_t* pos, int g, Put put) {
    if constexpr (CI) {
        const int64_t j = pos[g];
        if (j >= 0) put((int)j);
    } else {
        put(g);
    }
}

// The CI ring's orbit map in closed form (crypto/context.py): slot j
// evaluates at psi^(5^j mod 2N), which the forward transform (bit-reversed
// out) puts at position keep(j) = bitrev((5^j mod 2N - 1) / 2); its
// conjugate, position N - 1 - keep(j), holds the same value (ci_src maps
// both to j).  pow5_mod2n(j) = 5^j mod 2N; ci_keep_pos(5^j mod 2N) =
// keep(j).
template <int LOGN>
__device__ __forceinline__ uint32_t pow5_mod2n(int j) {
    constexpr uint32_t mask = (2u << LOGN) - 1;
    uint32_t r = 1u, b = 5u;
    for (; j; j >>= 1) {
        if (j & 1) r = (r * b) & mask;
        b = (b * b) & mask;
    }
    return r;
}

template <int LOGN>
__device__ __forceinline__ int ci_keep_pos(uint32_t pow5) {
    return (int)(__brev((pow5 - 1u) >> 1) >> (32 - LOGN));
}

// Input g of the inverse transform: the stored index it reads.
template <bool CI>
__device__ __forceinline__ int gather_at(const int64_t* src, int g) {
    if constexpr (CI) return (int)src[g];
    else return g;
}

// Allow more than the default 48 KB of dynamic shared memory when a row
// needs it (LogN 14: 66 KiB with the padding).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Calls f(std::integral_constant<int, LOGN>{}) for the ring sizes the port
// supports, N = 2^8 .. 2^14; returns what f returns.
template <class F>
inline cudaError_t with_logn(int logn, F f) {
    switch (logn) {
        case 8: return f(std::integral_constant<int, 8>{});
        case 9: return f(std::integral_constant<int, 9>{});
        case 10: return f(std::integral_constant<int, 10>{});
        case 11: return f(std::integral_constant<int, 11>{});
        case 12: return f(std::integral_constant<int, 12>{});
        case 13: return f(std::integral_constant<int, 13>{});
        case 14: return f(std::integral_constant<int, 14>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace orion
