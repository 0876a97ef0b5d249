"""CKKS context: parameters and all precomputed tables, host + device.

Counterpart of `orion_tpu/crypto/context.py`, for the standard and the
ConjugateInvariant ring.  The host tables (primes, twiddles, digit /
ModDown / rescale constants, the CI orbit maps) are computed by the same
code and are identical; the device dict holds them as int64 tensors on the
scheme's `torch.device`.

ConjugateInvariant (CI) ring of degree n: the conjugation-invariant
subring of the 2n-degree standard ring, n real slots.  Elements are
stored as n coefficients; every NTT routes through the 2n lift (lift, 2n
transform, keep the n orbit positions `ci_keep`; the inverse gathers the
2n positions from the n slots through `ci_src`), so the transform tables
are built at `lift_n` = 2n (`crypto/ntt.py`, `kernels/ntt.py`).

Hybrid key-switching uses the CRT-indicator gadget: the key for digit j
encrypts g_j * s' where g_j = P mod q_i on the digit's primes and 0 on all
other Q primes (and 0 mod every special prime).  This single key set is
valid at every level, so no per-level key material is generated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import placement
from . import primes as primegen
from .modops import shoup_precompute
from .ntt import CIMap
from .ntt4 import build_t4_tables
from .ref import CIHostRing, HostRing, bit_reverse_indices

# the largest transform the kernels instantiate (csrc/modarith.cuh with_logn)
MAX_KERNEL_LOGN = 14


def _shoup_arr(vals: np.ndarray, p: int) -> np.ndarray:
    """Vectorised Shoup companions: floor(v << 32 / p), exact in uint64."""
    v = np.asarray(vals, dtype=np.uint64)
    return ((v << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


@dataclass
class DigitTables:
    """Fast-basis-conversion constants for one decomposition digit."""
    src_idx: list[int]            # global prime indices of the digit
    qhat_inv: np.ndarray          # (alpha,)  [(D/d_m)^-1]_{d_m}
    qhat_inv_shoup: np.ndarray
    conv: np.ndarray              # (alpha, n_t)  [D/d_m]_t
    conv_shoup: np.ndarray
    d_mod_t: np.ndarray           # (n_t,)  [D]_t
    d_mod_t_shoup: np.ndarray
    src_q: np.ndarray             # (alpha,) source primes as float32 for v-est


@dataclass
class LevelKSTables:
    """Per-level key-switch/rescale constants (targets = q_0..q_l + specials)."""
    level: int
    digits: list[DigitTables]
    # ModDown by P: FBC from special primes to q_0..q_l, then * P^-1
    moddown: DigitTables
    pinv_mod_q: np.ndarray        # (l+1,) [P^-1]_{q_i}
    pinv_mod_q_shoup: np.ndarray
    # Rescale (drop q_l): centered lift of last limb + * q_l^-1
    qlast_mod_t: np.ndarray       # (l,) [q_l]_t
    qlast_mod_t_shoup: np.ndarray
    qlast_inv: np.ndarray         # (l,) [q_l^-1]_t
    qlast_inv_shoup: np.ndarray
    # Fused ModDown+rescale epilogue (divide by P*q_l in ONE basis
    # conversion): FBC from {specials, q_l} to q_0..q_{l-1}, then
    # * (P*q_l)^-1; P mod q_i lifts the ciphertext part into the
    # pre-division accumulator.  None at level 0 (nothing to rescale into).
    dropdown: DigitTables | None = None
    dqinv_mod_q: np.ndarray | None = None        # (l,) [(P q_l)^-1]_{q_i}
    dqinv_mod_q_shoup: np.ndarray | None = None
    p_mod_q: np.ndarray | None = None            # (l+1,) [P]_{q_i}
    p_mod_q_shoup: np.ndarray | None = None


class CKKSContext:
    """Every table needed by host crypto and device kernels.

    Host tables (numpy) are identical to orion_tpu's; the device dict holds
    the same values as int64 tensors on `device`: `cuda` by default, and
    without a CUDA device the constructor raises unless `device="cpu"` is
    asked for (`placement.resolve_device`)."""

    def __init__(self, logn: int, logq: list[int], logp: list[int],
                 logscale: int, h: int, ring_type: str = "standard",
                 seed: int = 0, device: str | torch.device | None = None):
        rt = ring_type.lower().replace("_", "").replace("-", "")
        if rt == "standard":
            self.ring_type = "standard"
        elif rt == "conjugateinvariant":
            self.ring_type = "conjugate_invariant"
        else:
            raise NotImplementedError(f"ring type {ring_type!r}")
        ci = self.ring_type == "conjugate_invariant"
        self.device = placement.resolve_device(device)
        self.logn = logn
        self.n = 1 << logn              # stored coefficient count
        self.lift_n = 2 * self.n if ci else self.n   # NTT ring degree
        self.slots = self.n if ci else self.n // 2
        self.gal_mod = 2 * self.lift_n  # Galois exponents live mod this
        lift_logn = self.lift_n.bit_length() - 1
        if lift_logn < 8:
            raise ValueError(
                f"transform size 2^{lift_logn} < 2^8: the four-step "
                f"transform needs at least 256 points")
        if self.device.type == "cuda" and lift_logn > MAX_KERNEL_LOGN:
            raise ValueError(
                f"LogN {logn} on the {self.ring_type} ring needs 2^"
                f"{lift_logn}-point transforms; the kernels go up to "
                f"2^{MAX_KERNEL_LOGN}")
        self.logq = list(logq)
        self.logp = list(logp)
        self.logscale = logscale
        self.default_scale = float(1 << logscale)
        self.h = h
        self.seed = seed

        qs = primegen.generate_primes(self.logq, self.gal_mod)
        ps = primegen.generate_primes(self.logp, self.gal_mod, avoid=set(qs))
        self.q_primes = qs              # moduli chain, q_0 first
        self.p_primes = ps              # special primes
        self.primes = qs + ps           # global prime order: Q then P
        self.n_q = len(qs)
        self.n_p = len(ps)
        self.n_all = self.n_q + self.n_p
        self.max_level = self.n_q - 1
        self.alpha = max(self.n_p, 1)
        self.P = 1
        for p in ps:
            self.P *= p

        self.psis = [primegen.primitive_root_2n(p, self.gal_mod)
                     for p in self.primes]

        # slot <-> evaluation-point bookkeeping for automorphisms/encoding
        self._brev = bit_reverse_indices(self.lift_n)
        # NTT-domain position j holds the evaluation at psi^(2*bitrev(j)+1)
        self._pos_to_exp = (2 * self._brev + 1) % self.gal_mod

        if ci:
            m = self.gal_mod
            rot = np.array([pow(5, j, m) for j in range(self.n)], np.int64)
            self._ci_exps = rot         # CI slot j evaluates at psi^rot[j]
            self._ci_slot_of = {int(e): j for j, e in enumerate(rot)}
            # 2n-NTT output position holding exponent e: brev[(e-1)/2]
            keep = self._brev[(rot - 1) // 2]
            src = np.empty(self.lift_n, np.int64)
            for p2 in range(self.lift_n):
                e = int(self._pos_to_exp[p2])
                j = self._ci_slot_of.get(e)
                if j is None:
                    j = self._ci_slot_of[m - e]
                src[p2] = j
            self.ci_keep = keep.astype(np.int32)
            self.ci_src = src.astype(np.int32)
            base = HostRing(self.primes, self.lift_n, self.psis)
            self.host = CIHostRing(base, self.n, self.ci_keep, self.ci_src)
        else:
            self.ci_keep = None
            self.ci_src = None
            self.host = HostRing(self.primes, self.n, self.psis)

        self._build_device_tables()
        self.ci = CIMap.from_ctx(self)      # None on the standard ring
        self.ks_tables = {l: self._build_level_tables(l)
                          for l in range(self.n_q)}
        self._perm_cache: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ #
    #  Device tables                                                     #
    # ------------------------------------------------------------------ #

    def _build_device_tables(self):
        n, n_all = self.lift_n, self.n_all
        p_arr = np.zeros(n_all, np.uint32)
        pinv = np.zeros(n_all, np.uint32)
        r_mod = np.zeros(n_all, np.uint32)
        r_shoup = np.zeros(n_all, np.uint32)
        tw = np.zeros((n_all, n), np.uint32)
        tw_sh = np.zeros((n_all, n), np.uint32)
        itw = np.zeros((n_all, n), np.uint32)
        itw_sh = np.zeros((n_all, n), np.uint32)
        ninv = np.zeros(n_all, np.uint32)
        ninv_sh = np.zeros(n_all, np.uint32)

        for i, p in enumerate(self.primes):
            ring = self.host.rings[i]
            p_arr[i] = p
            pinv[i] = (-pow(p, -1, 1 << 32)) % (1 << 32)
            r = (1 << 32) % p
            r_mod[i] = r
            r_shoup[i] = shoup_precompute(r, p)
            tw[i] = ring.tw.astype(np.uint32)
            tw_sh[i] = _shoup_arr(ring.tw, p)
            itw[i] = ring.itw.astype(np.uint32)
            itw_sh[i] = _shoup_arr(ring.itw, p)
            ninv[i] = ring.ninv
            ninv_sh[i] = shoup_precompute(ring.ninv, p)

        host = {
            "p": p_arr, "pinv": pinv,
            "tw": tw, "tw_shoup": tw_sh,
            "itw": itw, "itw_shoup": itw_sh,
            "r_mod": r_mod, "r_shoup": r_shoup,
            "ninv": ninv, "ninv_shoup": ninv_sh,
        }
        t4 = build_t4_tables(tw, itw, self.psis, self.primes,
                             n.bit_length() - 1)
        self.t4_keys = ["t4_" + k for k in t4]
        host.update({"t4_" + k: v for k, v in t4.items()})
        if self.ci_keep is not None:
            # the kernels' store map: the CI position of each 2n output
            # position, -1 where the forward transform drops it
            pos = np.full(n, -1, np.int64)
            pos[self.ci_keep] = np.arange(self.n)
            host.update(ci_keep=self.ci_keep, ci_src=self.ci_src,
                        ci_pos=pos)
        self.dev = {k: self.to_device(v) for k, v in host.items()}

    def to_device(self, x) -> torch.Tensor:
        """Host integers (numpy) -> int64 tensor on the context's device."""
        return placement.buffer(x, self.device)

    # ------------------------------------------------------------------ #
    #  Key-switch constants                                              #
    # ------------------------------------------------------------------ #

    def _digit_tables(self, src_idx: list[int], tgt_idx: list[int]) -> DigitTables:
        src = [self.primes[i] for i in src_idx]
        tgt = [self.primes[i] for i in tgt_idx]
        d_prod = 1
        for q in src:
            d_prod *= q
        alpha, n_t = len(src), len(tgt)
        qhat_inv = np.zeros(alpha, np.uint32)
        qhat_inv_sh = np.zeros(alpha, np.uint32)
        conv = np.zeros((alpha, n_t), np.uint32)
        conv_sh = np.zeros((alpha, n_t), np.uint32)
        d_mod = np.zeros(n_t, np.uint32)
        d_mod_sh = np.zeros(n_t, np.uint32)
        for m, qm in enumerate(src):
            qhat = d_prod // qm
            qi = pow(qhat % qm, -1, qm) if alpha > 1 else 1
            qhat_inv[m] = qi
            qhat_inv_sh[m] = shoup_precompute(qi, qm)
            for t, qt in enumerate(tgt):
                c = qhat % qt
                conv[m, t] = c
                conv_sh[m, t] = shoup_precompute(c, qt)
        for t, qt in enumerate(tgt):
            dm = d_prod % qt
            d_mod[t] = dm
            d_mod_sh[t] = shoup_precompute(dm, qt)
        return DigitTables(
            src_idx=list(src_idx),
            qhat_inv=qhat_inv, qhat_inv_shoup=qhat_inv_sh,
            conv=conv, conv_shoup=conv_sh,
            d_mod_t=d_mod, d_mod_t_shoup=d_mod_sh,
            src_q=np.asarray(src, dtype=np.float32),
        )

    def _build_level_tables(self, level: int) -> LevelKSTables:
        nq = level + 1
        tgt_idx = list(range(nq)) + list(range(self.n_q, self.n_all))
        digits = []
        for j in range(math.ceil(nq / self.alpha)):
            src = list(range(j * self.alpha, min((j + 1) * self.alpha, nq)))
            digits.append(self._digit_tables(src, tgt_idx))

        moddown = self._digit_tables(
            list(range(self.n_q, self.n_all)), list(range(nq)))
        pinv_q = np.zeros(nq, np.uint32)
        pinv_q_sh = np.zeros(nq, np.uint32)
        for i in range(nq):
            qi = self.primes[i]
            v = pow(self.P % qi, -1, qi)
            pinv_q[i] = v
            pinv_q_sh[i] = shoup_precompute(v, qi)

        # rescale constants (only meaningful for level >= 1)
        nl = max(level, 1)
        qlast = self.primes[level]
        ql_mod = np.zeros(level, np.uint32)
        ql_mod_sh = np.zeros(level, np.uint32)
        ql_inv = np.zeros(level, np.uint32)
        ql_inv_sh = np.zeros(level, np.uint32)
        for i in range(level):
            qi = self.primes[i]
            ql_mod[i] = qlast % qi
            ql_mod_sh[i] = shoup_precompute(qlast % qi, qi)
            v = pow(qlast % qi, -1, qi)
            ql_inv[i] = v
            ql_inv_sh[i] = shoup_precompute(v, qi)

        out = LevelKSTables(
            level=level, digits=digits, moddown=moddown,
            pinv_mod_q=pinv_q, pinv_mod_q_shoup=pinv_q_sh,
            qlast_mod_t=ql_mod, qlast_mod_t_shoup=ql_mod_sh,
            qlast_inv=ql_inv, qlast_inv_shoup=ql_inv_sh,
        )
        if level >= 1:
            sp_idx = list(range(self.n_q, self.n_all))
            out.dropdown = self._digit_tables(sp_idx + [level],
                                              list(range(level)))
            dq = self.P * qlast
            dqinv = np.zeros(level, np.uint32)
            dqinv_sh = np.zeros(level, np.uint32)
            pmod = np.zeros(nq, np.uint32)
            pmod_sh = np.zeros(nq, np.uint32)
            for i in range(level):
                qi = self.primes[i]
                v = pow(dq % qi, -1, qi)
                dqinv[i] = v
                dqinv_sh[i] = shoup_precompute(v, qi)
            for i in range(nq):
                qi = self.primes[i]
                pm = self.P % qi
                pmod[i] = pm
                pmod_sh[i] = shoup_precompute(pm, qi)
            out.dqinv_mod_q, out.dqinv_mod_q_shoup = dqinv, dqinv_sh
            out.p_mod_q, out.p_mod_q_shoup = pmod, pmod_sh
        return out

    # ------------------------------------------------------------------ #
    #  Automorphisms                                                     #
    # ------------------------------------------------------------------ #

    def automorphism_perm(self, k: int) -> np.ndarray:
        """NTT-domain permutation for tau_k: out[j] = in[perm[j]].

        Standard ring: position j evaluates at psi^e(j) with
        e(j) = 2*bitrev(j)+1; tau_k maps that to the evaluation at
        psi^(e(j)*k), i.e. input position j' with e(j') = e(j)*k mod 2N.
        CI ring: position j evaluates at psi^(5^j); tau_k sends it to the
        orbit representative of +-(5^j * k).
        """
        k = k % self.gal_mod
        if k in self._perm_cache:
            return self._perm_cache[k]
        if self.ring_type == "conjugate_invariant":
            m = self.gal_mod
            e_src = (self._ci_exps * k) % m
            perm = np.array(
                [self._ci_slot_of.get(int(e), self._ci_slot_of.get(m - int(e)))
                 for e in e_src], np.int32)
        else:
            e = self._pos_to_exp
            e_src = (e * k) % self.gal_mod
            # invert e(j') = 2*bitrev(j')+1  =>  j' = bitrev((e_src-1)/2)
            perm = self._brev[(e_src - 1) // 2].astype(np.int32)
        self._perm_cache[k] = perm
        return perm

    def galois_element(self, rot: int) -> int:
        """Galois element for a left rotation by `rot` slots."""
        return pow(5, rot % self.slots, self.gal_mod)

    def galois_element_conj(self) -> int:
        """Conjugation element (identity on the CI ring: slots are real)."""
        if self.ring_type == "conjugate_invariant":
            return 1
        return self.gal_mod - 1

    # ------------------------------------------------------------------ #
    #  Misc helpers                                                      #
    # ------------------------------------------------------------------ #

    def q_prod(self, level: int) -> int:
        out = 1
        for q in self.q_primes[: level + 1]:
            out *= q
        return out

    def moduli_chain(self) -> list[int]:
        return list(self.q_primes)
