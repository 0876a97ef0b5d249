// Native host-side negacyclic NTT/iNTT (C++, OpenMP).
//
// The compile-time hot loop: packing a deep net encodes tens of thousands
// of diagonal plaintexts, each a per-limb forward NTT on the host
// (orion_tpu_torch/crypto/ref.py PrimeRing.ntt).  The numpy butterflies pay a
// full (rows x n) pass + temporaries per stage; this kernel runs the whole
// transform in-cache per row with Shoup multiplication and parallelises
// over (batch x limb) rows.  Bit-exact vs the numpy path (same DIT
// bit-reversed-twiddle formulation); tests/test_torch_ring.py.
//
// Reference parity note: the reference keeps this work native too —
// encode/NTT live in Lattigo's Go ring package
// (orion/backend/lattigo/encoder.go); this is the port's analogue
// for the host side of the pipeline.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (orion_tpu_torch/native/__init__.py).

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;

// Shoup modular multiply: s_sh = floor(s * 2^64 / p), p < 2^31, x < p.
static inline uint64_t mulmod_shoup(uint64_t x, uint64_t s, uint64_t s_sh,
                                    uint64_t p) {
    uint64_t q = (uint64_t)(((u128)x * s_sh) >> 64);
    uint64_t r = x * s - q * p;  // both taken mod 2^64
    return r >= p ? r - p : r;
}

static inline uint64_t addmod(uint64_t a, uint64_t b, uint64_t p) {
    uint64_t r = a + b;
    return r >= p ? r - p : r;
}

static inline uint64_t submod(uint64_t a, uint64_t b, uint64_t p) {
    return a >= b ? a - b : a + p - b;
}

extern "C" {

// Forward negacyclic NTT over `nrows` length-`n` rows, in place.
// a: int64[nrows, n] residues in [0, p_row).  prime_idx[r] selects the
// row's tables: primes[k], tw/tw_shoup[k*n .. k*n+n) (bit-reversed psi
// powers, matching PrimeRing.tw).
void ntt_rows(int64_t* a, int64_t nrows, int64_t n,
              const int64_t* prime_idx, const int64_t* primes,
              const int64_t* tw, const uint64_t* tw_shoup) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; ++r) {
        const int64_t k = prime_idx[r];
        const uint64_t p = (uint64_t)primes[k];
        const int64_t* twk = tw + k * n;
        const uint64_t* twsk = tw_shoup + k * n;
        uint64_t* row = (uint64_t*)(a + r * n);
        int64_t t = n, m = 1;
        while (m < n) {
            t >>= 1;
            for (int64_t i = 0; i < m; ++i) {
                const uint64_t s = (uint64_t)twk[m + i];
                const uint64_t s_sh = twsk[m + i];
                uint64_t* lo = row + 2 * i * t;
                uint64_t* hi = lo + t;
                for (int64_t j = 0; j < t; ++j) {
                    const uint64_t v = mulmod_shoup(hi[j], s, s_sh, p);
                    const uint64_t u = lo[j];
                    lo[j] = addmod(u, v, p);
                    hi[j] = submod(u, v, p);
                }
            }
            m <<= 1;
        }
    }
}

// Inverse negacyclic NTT (bit-rev order in, standard order out), in place.
// itw: bit-reversed psi^-1 powers (PrimeRing.itw); ninv/ninv_shoup: n^-1.
void intt_rows(int64_t* a, int64_t nrows, int64_t n,
               const int64_t* prime_idx, const int64_t* primes,
               const int64_t* itw, const uint64_t* itw_shoup,
               const int64_t* ninv, const uint64_t* ninv_shoup) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; ++r) {
        const int64_t k = prime_idx[r];
        const uint64_t p = (uint64_t)primes[k];
        const int64_t* twk = itw + k * n;
        const uint64_t* twsk = itw_shoup + k * n;
        uint64_t* row = (uint64_t*)(a + r * n);
        int64_t t = 1, m = n;
        while (m > 1) {
            m >>= 1;
            for (int64_t i = 0; i < m; ++i) {
                const uint64_t s = (uint64_t)twk[m + i];
                const uint64_t s_sh = twsk[m + i];
                uint64_t* lo = row + 2 * i * t;
                uint64_t* hi = lo + t;
                for (int64_t j = 0; j < t; ++j) {
                    const uint64_t u = lo[j];
                    const uint64_t w = hi[j];
                    lo[j] = addmod(u, w, p);
                    hi[j] = mulmod_shoup(submod(u, w, p), s, s_sh, p);
                }
            }
            t <<= 1;
        }
        const uint64_t nv = (uint64_t)ninv[k];
        const uint64_t nv_sh = ninv_shoup[k];
        for (int64_t j = 0; j < n; ++j)
            row[j] = mulmod_shoup(row[j], nv, nv_sh, p);
    }
}

}  // extern "C"
