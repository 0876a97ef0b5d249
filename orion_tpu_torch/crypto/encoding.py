"""Host-side CKKS encode/decode via the canonical embedding.

Counterpart of `orion_tpu/crypto/encoding.py` (same code, both rings).
Like a real deployment, encode/decode/keygen/encrypt/decrypt are
client-side host operations (numpy float64/bigint, exact integer
handling); only homomorphic evaluation runs on the device.

Slot convention: slot j holds m(psi^{e_j}) with e_j = 5^j mod 2N (standard
CKKS orbit), so a Galois automorphism with element 5^r is a left-rotation by
r slots.  The embedding is evaluated with length-2N FFTs (O(N log N)).

Precision: float64 gives relative encoding error ~2^-53, far below the CKKS
noise floor for every parameter set in configs/ (the e2e oracle is the
reference's MAE < 0.005 bound, `tests/models/test_mlp.py:47`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .context import CKKSContext
from .ref import ci_lift_int

# encode_batch: vectors per thread's group, and threads at most
_ENCODE_GROUP = 16
_ENCODE_THREADS = 8


class Encoder:
    def __init__(self, ctx: CKKSContext):
        self.ctx = ctx
        # embedding runs in the NTT (lift) ring: degree n for the standard
        # ring, 2n for conjugate-invariant (whose elements are the
        # conjugation-symmetric half of the 2n ring: all slots real)
        self.emb_n = ctx.lift_n
        two_m = 2 * self.emb_n
        slots = ctx.slots
        e = np.empty(slots, dtype=np.int64)
        acc = 1
        for j in range(slots):
            e[j] = acc
            acc = (acc * 5) % two_m
        self.rot_group = e  # e_j = 5^j mod 2*emb_n

    # -------------------- embedding -------------------- #

    def slots_to_coeffs(self, v: np.ndarray) -> np.ndarray:
        """Inverse canonical embedding: slots -> real coeffs (stored width).

        a_k = (2/M) * Re( sum_j v_j * conj(psi^(k e_j)) ), computed by
        placing v_j at spectrum position e_j and taking a length-2M FFT.
        CI ring: v is real (slots = n); the resulting lift coefficients
        are antisymmetric and the stored first n are returned.
        """
        m, two_m = self.emb_n, 2 * self.emb_n
        spec = np.zeros(two_m, dtype=np.complex128)
        spec[self.rot_group] = v
        a = (2.0 / m) * np.fft.fft(spec)[:m].real
        return a[: self.ctx.n]

    def coeffs_to_slots(self, a: np.ndarray) -> np.ndarray:
        """Canonical embedding: stored coeffs -> slot values."""
        two_m = 2 * self.emb_n
        if self.ctx.ring_type == "conjugate_invariant":
            a = ci_lift_int(np.asarray(a, dtype=np.float64))
        vals = np.fft.ifft(a, two_m) * two_m
        return vals[self.rot_group]

    # -------------------- integer paths -------------------- #

    def coeffs_to_rns(self, coeffs: np.ndarray, level: int) -> np.ndarray:
        """Round real coefficients and reduce mod the first level+1 primes."""
        nl = level + 1
        c = np.round(coeffs)
        if np.max(np.abs(c)) < 2**62:
            ci = c.astype(np.int64)
            return self.ctx.host.reduce(ci, nl)
        # big coefficients: exact via python ints (rare; bootstrap-scale)
        ci = np.array([int(x) for x in c], dtype=object)
        return self.ctx.host.reduce(ci, nl)

    def rns_to_coeffs(self, rns: np.ndarray) -> np.ndarray:
        """CRT-reconstruct centered integer coefficients -> float64."""
        nl = rns.shape[0]
        primes = self.ctx.q_primes[:nl]
        q_prod = self.ctx.q_prod(nl - 1)
        if nl == 1:
            p = primes[0]
            x = rns[0].astype(np.int64)
            x = np.where(x > p // 2, x - p, x)
            return x.astype(np.float64)
        acc = np.zeros(self.ctx.n, dtype=object)
        for i, p in enumerate(primes):
            qhat = q_prod // p
            coef = (qhat * pow(qhat % p, -1, p)) % q_prod
            acc = (acc + rns[i].astype(object) * coef) % q_prod
        acc = np.where(acc > q_prod // 2, acc - q_prod, acc)
        return acc.astype(np.float64)

    # -------------------- public API -------------------- #

    def encode(self, values: np.ndarray, level: int | None = None,
               scale: float | None = None, with_shoup: bool = False):
        """Encode one slot vector (len <= slots, zero-padded) into RNS NTT form.

        Returns (rns_ntt int64[level+1, N], scale).  `with_shoup` additionally
        returns the uint32 Shoup companion for plaintext-multiplicand use.
        """
        ctx = self.ctx
        if level is None:
            level = ctx.max_level
        if scale is None:
            scale = ctx.default_scale
        v = np.zeros(ctx.slots, dtype=np.complex128)
        flat = np.asarray(values).reshape(-1)
        v[: flat.shape[0]] = flat
        coeffs = self.slots_to_coeffs(v) * scale
        rns = self.coeffs_to_rns(coeffs, level)
        rns_ntt = ctx.host.ntt(rns)
        if not with_shoup:
            return rns_ntt, float(scale)
        shoup = np.empty_like(rns_ntt, dtype=np.uint32)
        for i in range(level + 1):
            p = np.uint64(ctx.primes[i])
            shoup[i] = ((rns_ntt[i].astype(np.uint64) << np.uint64(32)) // p
                        ).astype(np.uint32)
        return rns_ntt, shoup, float(scale)

    def encode_batch(self, vecs: np.ndarray, level: int | None = None,
                     scale: float | None = None, with_shoup: bool = False):
        """Encode a batch of slot vectors at one (level, scale) in one shot.

        The compile-time hot loop: a ResNet packs hundreds of diagonals per
        transform, and per-vector `encode` pays the embedding FFT, CRT
        reduction and host NTT stage overheads B times.  Here the whole
        batch rides each stage once (the host NTT butterflies vectorise over
        the batch axis).  Returns (rns_ntt int64[B, level+1, N], scale) or
        (rns_ntt, shoup uint32[B, level+1, N], scale) with `with_shoup`.
        """
        ctx = self.ctx
        if level is None:
            level = ctx.max_level
        if scale is None:
            scale = ctx.default_scale
        vecs = np.asarray(vecs)
        # for a scheme on the card, groups of vectors encode on threads, as
        # many as torch's intra-op threads: they share nothing, and numpy's
        # loops and the native NTT release the GIL (the same bits as one
        # thread).  On device cpu the host's cores are torch's, and groups
        # run in turn.  The first group runs alone: it builds the lazily
        # made host tables.
        threads = (min(_ENCODE_THREADS, torch.get_num_threads())
                   if ctx.device.type == "cuda" else 1)
        groups = [vecs[lo: lo + _ENCODE_GROUP]
                  for lo in range(0, vecs.shape[0], _ENCODE_GROUP)]

        def encode(g):
            return self._encode_group(g, level, scale, with_shoup)

        parts = [encode(groups[0])]
        if threads > 1:
            with ThreadPoolExecutor(threads) as pool:
                parts += pool.map(encode, groups[1:])
        else:
            parts += map(encode, groups[1:])
        rns_ntt = np.concatenate([d for d, _ in parts])
        if not with_shoup:
            return rns_ntt, float(scale)
        return rns_ntt, np.concatenate([sh for _, sh in parts]), float(scale)

    def _encode_group(self, vecs, level, scale, with_shoup):
        """encode_batch of one group: (rns_ntt, shoup or None)."""
        ctx = self.ctx
        b = vecs.shape[0]
        m, two_m = self.emb_n, 2 * self.emb_n
        # chunked: small batches amortise numpy stage overhead while the
        # per-stage working set stays cache-resident (measured optimum ~4
        # at N=8192; full-batch butterflies go memory-bound and LOSE)
        chunk = 4
        datas, shoups = [], []
        for lo in range(0, b, chunk):
            vc = vecs[lo: lo + chunk]
            v = np.zeros((vc.shape[0], ctx.slots), dtype=np.complex128)
            v[:, : vc.shape[1]] = vc
            spec = np.zeros((vc.shape[0], two_m), dtype=np.complex128)
            spec[:, self.rot_group] = v
            a = (2.0 / m) * np.fft.fft(spec, axis=-1)[:, :m].real
            coeffs = np.round(a[:, : ctx.n] * scale)
            if not np.max(np.abs(coeffs)) < 2**62:
                # bootstrap-scale coefficients: exact per-vector path
                for i in range(vc.shape[0]):
                    out = self.encode(vc[i], level, scale, with_shoup)
                    datas.append(out[0][None])
                    if with_shoup:
                        shoups.append(out[1][None])
                continue
            rns = ctx.host.reduce(coeffs.astype(np.int64), level + 1)
            rns_ntt = ctx.host.ntt(rns)
            datas.append(rns_ntt)
            if with_shoup:
                sh = np.empty_like(rns_ntt, dtype=np.uint32)
                for i in range(level + 1):
                    p = np.uint64(ctx.primes[i])
                    sh[:, i] = ((rns_ntt[:, i].astype(np.uint64)
                                 << np.uint64(32)) // p).astype(np.uint32)
                shoups.append(sh)
        return (np.concatenate(datas),
                np.concatenate(shoups) if with_shoup else None)

    def decode(self, rns_ntt: np.ndarray, scale: float,
               num_values: int | None = None) -> np.ndarray:
        """RNS NTT plaintext -> real slot values."""
        ctx = self.ctx
        rns = ctx.host.intt(np.asarray(rns_ntt, dtype=np.int64))
        coeffs = self.rns_to_coeffs(rns) / scale
        vals = self.coeffs_to_slots(coeffs).real
        if num_values is not None:
            vals = vals[:num_values]
        return vals
