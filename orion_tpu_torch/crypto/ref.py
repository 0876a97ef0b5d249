"""Host-side exact RNS ring arithmetic (numpy int64).

Two roles:
  1. Oracle for the device path (the four-step torch NTT and the CUDA
     kernels compute the same transforms bit for bit).
  2. Host execution of client-side crypto that never touches the GPU:
     key generation, encryption and decryption (reference parity:
     `orion/backend/lattigo/{keygenerator,encryptor}.go`).

Primes are < 2^31 so products of residues fit in int64; everything here is
exact.  Layout conventions (shared with the device path):
  * A polynomial in RNS form is `int64[L, N]` (L limbs, N coefficients),
    residues in [0, p).
  * "NTT domain" means the merged negacyclic NTT (psi-twisted, Cooley-Tukey
    decimation-in-time with bit-reversed twiddle table).  Outputs are in
    bit-reversed evaluation order; position j holds the evaluation at
    psi^(2*bitrev(j)+1).  All pointwise ops and key material use this order.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _shoup64(vals: np.ndarray, p: int) -> np.ndarray:
    """floor(v * 2^64 / p) as uint64 (exact, via python bigints)."""
    return ((vals.astype(object) << 64) // p).astype(np.uint64)


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


class PrimeRing:
    """Negacyclic NTT tables for one prime (host, exact)."""

    def __init__(self, p: int, n: int, psi: int):
        self.p = p
        self.n = n
        self.logn = n.bit_length() - 1
        self.psi = psi
        rev = bit_reverse_indices(n)
        pows = np.zeros(n, dtype=np.int64)
        ipows = np.zeros(n, dtype=np.int64)
        psi_inv = pow(psi, p - 2, p)
        acc, iacc = 1, 1
        tmp = np.zeros(n, dtype=object)
        itmp = np.zeros(n, dtype=object)
        for i in range(n):
            tmp[i] = acc
            itmp[i] = iacc
            acc = acc * psi % p
            iacc = iacc * psi_inv % p
        # twiddles in bit-reversed order: tw[j] = psi^bitrev(j)
        pows[:] = tmp[rev].astype(np.int64)
        ipows[:] = itmp[rev].astype(np.int64)
        self.tw = pows
        self.itw = ipows
        self.ninv = pow(n, p - 2, p)
        self._nat = None  # lazy native (C++/OpenMP) tables

    def _native_tables(self):
        if self._nat is None:
            p = self.p
            self._nat = dict(
                primes=np.array([p], np.int64),
                tw=np.ascontiguousarray(self.tw[None]),
                tw_shoup=np.ascontiguousarray(_shoup64(self.tw, p)[None]),
                itw=np.ascontiguousarray(self.itw[None]),
                itw_shoup=np.ascontiguousarray(_shoup64(self.itw, p)[None]),
                ninv=np.array([self.ninv], np.int64),
                ninv_shoup=_shoup64(np.array([self.ninv], np.int64), p),
            )
        return self._nat

    def ntt(self, a: np.ndarray) -> np.ndarray:
        """Forward negacyclic NTT, standard-order input -> bit-rev order
        output.  Accepts any leading batch shape (..., n); the butterfly
        stages vectorise over the whole batch (the compile-time encode of
        hundreds of diagonals rides this path)."""
        p, n = self.p, self.n
        shape = a.shape
        a = np.ascontiguousarray(a.astype(np.int64).reshape(-1, n))
        if native.get_lib() is not None and n >= 256:
            t = self._native_tables()
            idx = np.zeros(a.shape[0], np.int64)
            native.ntt_rows(a, idx, t["primes"], t["tw"], t["tw_shoup"])
            return a.reshape(shape)
        b = a.shape[0]
        t = n
        m = 1
        while m < n:
            t //= 2
            # view as (b, m, 2, t): butterfly between group halves
            v = a.reshape(b, m, 2, t)
            s = self.tw[m : 2 * m].reshape(m, 1)
            odd = v[:, :, 1, :] * s % p
            even = v[:, :, 0, :]
            a = np.stack([(even + odd) % p, (even - odd) % p],
                         axis=2).reshape(b, -1)
            m *= 2
        return a.reshape(shape)

    def intt(self, a: np.ndarray) -> np.ndarray:
        """Inverse NTT, bit-rev order input -> standard-order output.
        Accepts any leading batch shape (..., n) like `ntt`."""
        p, n = self.p, self.n
        shape = a.shape
        a = np.ascontiguousarray(a.astype(np.int64).reshape(-1, n))
        if native.get_lib() is not None and n >= 256:
            t = self._native_tables()
            idx = np.zeros(a.shape[0], np.int64)
            native.intt_rows(a, idx, t["primes"], t["itw"], t["itw_shoup"],
                             t["ninv"], t["ninv_shoup"])
            return a.reshape(shape)
        b = a.shape[0]
        t = 1
        m = n
        while m > 1:
            m //= 2
            v = a.reshape(b, m, 2, t)
            s = self.itw[m : 2 * m].reshape(m, 1)
            u = v[:, :, 0, :]
            w = v[:, :, 1, :]
            a = np.stack([(u + w) % p, (u - w) * s % p],
                         axis=2).reshape(b, -1)
            t *= 2
        return (a * self.ninv % p).reshape(shape)

class HostRing:
    """All-prime host ring: vectorised NTT over the limb dimension."""

    def __init__(self, primes: list[int], n: int, psis: list[int]):
        self.primes = list(primes)
        self.n = n
        self.rings = [PrimeRing(p, n, psi) for p, psi in zip(primes, psis)]
        self._nat = None  # lazy stacked native tables over all primes

    def _native_tables(self):
        if self._nat is None:
            self._nat = dict(
                primes=np.array(self.primes, np.int64),
                tw=np.ascontiguousarray(
                    np.stack([r.tw for r in self.rings])),
                tw_shoup=np.ascontiguousarray(np.stack(
                    [_shoup64(r.tw, r.p) for r in self.rings])),
                itw=np.ascontiguousarray(
                    np.stack([r.itw for r in self.rings])),
                itw_shoup=np.ascontiguousarray(np.stack(
                    [_shoup64(r.itw, r.p) for r in self.rings])),
                ninv=np.array([r.ninv for r in self.rings], np.int64),
                ninv_shoup=np.concatenate(
                    [_shoup64(np.array([r.ninv], np.int64), r.p)
                     for r in self.rings]),
            )
        return self._nat

    def _native_rows(self, a: np.ndarray):
        """(..., L, n) -> (contiguous int64 rows, per-row prime index)."""
        nl = a.shape[-2]
        rows = np.ascontiguousarray(
            a.astype(np.int64).reshape(-1, self.n))
        idx = np.tile(np.arange(nl, dtype=np.int64), rows.shape[0] // nl)
        return rows, idx

    def ntt(self, a: np.ndarray) -> np.ndarray:
        """(..., L, n) -> per-limb NTT; batch dims vectorise in PrimeRing.
        With the native kernel, all (batch x limb) rows go in one
        OpenMP-parallel call."""
        self._sel(a)
        if native.get_lib() is not None and self.n >= 256:
            t = self._native_tables()
            rows, idx = self._native_rows(a)
            native.ntt_rows(rows, idx, t["primes"], t["tw"], t["tw_shoup"])
            return rows.reshape(a.shape)
        return np.stack([r.ntt(a[..., i, :])
                         for i, r in enumerate(self._sel(a))], axis=-2)

    def intt(self, a: np.ndarray) -> np.ndarray:
        self._sel(a)
        if native.get_lib() is not None and self.n >= 256:
            t = self._native_tables()
            rows, idx = self._native_rows(a)
            native.intt_rows(rows, idx, t["primes"], t["itw"],
                             t["itw_shoup"], t["ninv"], t["ninv_shoup"])
            return rows.reshape(a.shape)
        return np.stack([r.intt(a[..., i, :])
                         for i, r in enumerate(self._sel(a))], axis=-2)

    def _sel(self, a: np.ndarray):
        assert a.ndim >= 2 and a.shape[-1] == self.n, a.shape
        return self.rings[: a.shape[-2]]

    def reduce(self, coeffs: np.ndarray, num_limbs: int) -> np.ndarray:
        """Signed integer coefficients (object or int64, any batch shape
        (..., n)) -> RNS residues (..., num_limbs, n)."""
        out = np.zeros(coeffs.shape[:-1] + (num_limbs, self.n),
                       dtype=np.int64)
        for i in range(num_limbs):
            out[..., i, :] = np.asarray(coeffs % self.rings[i].p,
                                        dtype=np.int64)
        return out


# ------------------------------------------------------------------ #
#  Conjugate-invariant ring (real slots)                             #
# ------------------------------------------------------------------ #

def ci_lift_int(a: np.ndarray, p=None) -> np.ndarray:
    """Lift CI coefficients (..., n) to the 2n-degree standard ring.

    A conjugate-invariant element f = a_0 + sum_i a_i (X^i + X^{-i}) of
    Z[X]/(X^{2n}+1) has power-basis coefficients
    (a_0, a_1, .., a_{n-1}, 0, -a_{n-1}, .., -a_1) since X^{-i} = -X^{2n-i}.
    With `p` given (an int, or per-limb moduli broadcast over the last
    axis), negation is mod p (residue inputs); otherwise signed.
    """
    tail = a[..., 1:][..., ::-1]
    if p is None:
        neg = -tail
    else:
        neg = np.where(tail == 0, 0, p - tail)
    zeros = np.zeros(a.shape[:-1] + (1,), a.dtype)
    return np.concatenate([a, zeros, neg], axis=-1)


class CIHostRing:
    """Conjugate-invariant host ring of degree n (real slots = n).

    Elements are stored as n coefficients (the X^i + X^{-i} basis);
    NTT/iNTT route through the 2n-degree standard ring: lift -> 2n NTT ->
    keep the n orbit-representative positions (exponents 5^j mod 4n);
    inverse: replicate each value onto both orbit positions (CI elements
    take equal values at e and -e), 2n iNTT, project to the first n
    coefficients (the tail is the lift's antisymmetric mirror).
    """

    def __init__(self, base: HostRing, n: int,
                 keep: np.ndarray, src: np.ndarray):
        self.base = base
        self.primes = base.primes
        self.rings = base.rings        # 2n-degree tables (device build)
        self.n = n
        self.keep = keep               # (n,) positions kept after 2n NTT
        self.src = src                 # (2n,) CI slot feeding each position

    def _moduli(self, a: np.ndarray) -> np.ndarray:
        assert a.ndim >= 2 and a.shape[-1] == self.n, a.shape
        return np.array(self.primes[: a.shape[-2]], np.int64)[:, None]

    def ntt(self, a: np.ndarray) -> np.ndarray:
        p = self._moduli(a)
        return self.base.ntt(ci_lift_int(a, p))[..., self.keep]

    def intt(self, a: np.ndarray) -> np.ndarray:
        self._moduli(a)
        return self.base.intt(a[..., self.src])[..., : self.n]

    def reduce(self, coeffs: np.ndarray, num_limbs: int) -> np.ndarray:
        out = np.zeros(coeffs.shape[:-1] + (num_limbs, self.n),
                       dtype=np.int64)
        for i in range(num_limbs):
            out[..., i, :] = np.asarray(coeffs % self.rings[i].p,
                                        dtype=np.int64)
        return out
