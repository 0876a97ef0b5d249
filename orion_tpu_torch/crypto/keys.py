"""Key generation, encryption, decryption (exact integer arithmetic).

Counterpart of `orion_tpu/crypto/keys.py`: the same sampling from the same
seeded `np.random.Generator` in the same order, so keys and ciphertexts
equal orion_tpu's bit for bit.  Sampling, the error's NTT, encryption and
decryption run on the host in exact numpy int64; a key-switching key's
per-prime arithmetic (b = e - a*s, the gadget term, the Shoup companions)
runs in exact int64 torch ops on the context's device, where the key is
kept as int64 tensors.

Hybrid key-switching keys use the CRT-indicator gadget (see context.py): the
key for digit j satisfies  ksk0 + ksk1*s = g_j*s' + e  with
g_j = P (mod q_i in digit j), 0 (mod all other primes).  One key set serves
every ciphertext level (reference behaviour of Lattigo's evaluation keys).

Rotation keys are generated lazily per Galois element and cached, when the
compiler announces the rotation set (sorted per layer, as orion_tpu does):
the generation order fixes every later draw, encryption included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .context import CKKSContext
from .ref import ci_lift_int


class KeySwitchKey:
    """Device-resident hybrid KSK: (dnum, 2, n_all, N) int64 residues and
    their Shoup companions floor(v * 2^32 / p), int64 too."""

    def __init__(self, data: torch.Tensor, p: torch.Tensor):
        self.data = data
        # v < p < 2^31, so v << 32 fits in int64 and the quotient in 32 bits
        self.shoup = (data << 32) // p


class KeyChest:
    def __init__(self, ctx: CKKSContext, seed: int | None = None,
                 secret: np.ndarray | None = None):
        self.ctx = ctx
        self.rng = np.random.default_rng(
            ctx.seed if seed is None else seed)
        self.sigma = 3.2
        self._dev = None  # primes, s and P mod q on the device, made once

        n, n_all = ctx.n, ctx.n_all
        if secret is not None:
            s = np.asarray(secret, dtype=np.int64)
        else:
            # secret: ternary, hamming weight h
            s = np.zeros(n, dtype=np.int64)
            idx = self.rng.choice(n, size=ctx.h, replace=False)
            s[idx] = self.rng.choice(np.array([-1, 1]), size=ctx.h)
        self.s_coeff = s
        self.s_ntt = ctx.host.ntt(self._lift(s, n_all))

        # public key over the full Q chain
        nq = ctx.n_q
        self.pk_a = self._uniform_ntt(nq)
        e = ctx.host.ntt(self._lift(self._gauss(), nq))
        self.pk_b = np.empty_like(self.pk_a)
        for i in range(nq):
            p = ctx.primes[i]
            self.pk_b[i] = (e[i] - self.pk_a[i] * self.s_ntt[i]) % p

        # relinearisation key: s' = s^2
        s2_ntt = np.empty_like(self.s_ntt)
        for i in range(n_all):
            s2_ntt[i] = self.s_ntt[i] * self.s_ntt[i] % ctx.primes[i]
        self.relin_key = self._gen_ksk(s2_ntt)
        self.galois_keys: dict[int, KeySwitchKey] = {}
        # io_mode load: saved Galois keys, read on first use
        # (runtime/io.KeyArchive); a key it lacks is generated
        self.stored = None

    # ----------------------------- sampling ----------------------------- #

    def _gauss(self) -> np.ndarray:
        return np.round(self.rng.normal(0.0, self.sigma, self.ctx.n)
                        ).astype(np.int64)

    def _ternary(self) -> np.ndarray:
        return self.rng.integers(-1, 2, self.ctx.n).astype(np.int64)

    def _uniform_ntt(self, num_limbs: int) -> np.ndarray:
        out = np.empty((num_limbs, self.ctx.n), dtype=np.int64)
        for i in range(num_limbs):
            out[i] = self.rng.integers(0, self.ctx.primes[i], self.ctx.n)
        return out

    def _lift(self, coeffs: np.ndarray, num_limbs: int) -> np.ndarray:
        """Signed coefficient poly -> residues for the first num_limbs primes."""
        out = np.empty((num_limbs, self.ctx.n), dtype=np.int64)
        for i in range(num_limbs):
            out[i] = coeffs % self.ctx.primes[i]
        return out

    # ----------------------------- keyswitch ----------------------------- #

    def _gen_ksk(self, s_prime_ntt: np.ndarray) -> KeySwitchKey:
        ctx = self.ctx
        n_all = ctx.n_all
        dnum = math.ceil(ctx.n_q / ctx.alpha)
        a, e = [], []
        for _ in range(dnum):
            a.append(self._uniform_ntt(n_all))
            e.append(ctx.host.ntt(self._lift(self._gauss(), n_all)))
        dev = ctx.device
        if self._dev is None:
            p = torch.as_tensor(ctx.primes[:n_all], device=dev)[:, None]
            self._dev = (p, torch.as_tensor(self.s_ntt, device=dev),
                         torch.as_tensor([ctx.P % q for q in ctx.primes],
                                         device=dev)[:, None])
        p, s, p_mod = self._dev
        a = torch.as_tensor(np.stack(a), device=dev)
        # residues < 2^31: every product below fits in int64
        b = (torch.as_tensor(np.stack(e), device=dev) - a * s) % p
        s_prime = torch.as_tensor(s_prime_ntt[:ctx.n_q], device=dev)
        for j in range(dnum):
            d = slice(j * ctx.alpha, min((j + 1) * ctx.alpha, ctx.n_q))
            b[j, d] = (b[j, d] + p_mod[d] * s_prime[d]) % p[d]
        return KeySwitchKey(torch.stack([b, a], dim=1), p)

    def galois_key(self, k: int) -> KeySwitchKey:
        """KSK from tau_k(s) to s, cached per Galois element (read from
        `stored` when it holds the element's key)."""
        k = k % self.ctx.gal_mod
        if k not in self.galois_keys and self.stored is not None:
            key = self.stored.galois_key(k)
            if key is not None:
                self.galois_keys[k] = key
        if k not in self.galois_keys:
            ctx = self.ctx
            # automorphism over signed coeffs, exact on the +-1 entries;
            # CI ring: apply in the 2n lift and project back (tau_k
            # preserves conjugation-invariance)
            if ctx.ring_type == "conjugate_invariant":
                src = ci_lift_int(self.s_coeff)
            else:
                src = self.s_coeff
            m = src.shape[0]
            sk = np.zeros(m, dtype=np.int64)
            idx = (np.arange(m, dtype=np.int64) * k) % (2 * m)
            hi = idx >= m
            pos = np.where(hi, idx - m, idx)
            sk[pos] = np.where(hi, -src, src)
            s_rot_ntt = ctx.host.ntt(self._lift(sk[: ctx.n], ctx.n_all))
            self.galois_keys[k] = self._gen_ksk(s_rot_ntt)
        return self.galois_keys[k]

    def rotation_key(self, rot: int) -> KeySwitchKey:
        return self.galois_key(self.ctx.galois_element(rot))

    # ----------------------------- encrypt/decrypt ----------------------------- #

    def encrypt_rns(self, m_ntt: np.ndarray) -> np.ndarray:
        """Public-key encrypt an RNS NTT plaintext -> int64[2, L, N]."""
        ctx = self.ctx
        nl = m_ntt.shape[0]
        u_ntt = ctx.host.ntt(self._lift(self._ternary(), nl))
        e0 = ctx.host.ntt(self._lift(self._gauss(), nl))
        e1 = ctx.host.ntt(self._lift(self._gauss(), nl))
        ct = np.empty((2, nl, ctx.n), dtype=np.int64)
        for i in range(nl):
            p = ctx.primes[i]
            ct[0, i] = (self.pk_b[i] * u_ntt[i] + e0[i] + m_ntt[i]) % p
            ct[1, i] = (self.pk_a[i] * u_ntt[i] + e1[i]) % p
        return ct

    def decrypt_rns(self, ct: np.ndarray) -> np.ndarray:
        """int64[2, L, N] NTT ciphertext -> RNS NTT plaintext."""
        ctx = self.ctx
        nl = ct.shape[1]
        out = np.empty((nl, ctx.n), dtype=np.int64)
        for i in range(nl):
            p = ctx.primes[i]
            out[i] = (ct[0, i] + ct[1, i] * self.s_ntt[i]) % p
        return out
