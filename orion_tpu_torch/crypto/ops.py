"""Homomorphic evaluator over Ciphertext tensors.

Counterpart of `orion_tpu/crypto/ops.py`, with the same scale and level
semantics:

  * mul_plain / mul_relin relinearise-and-rescale in one logical op;
  * mul_scalar with a float encodes the scalar at the *current* prime q_l
    so the subsequent rescale divides q_l/q_l exactly (errorless drop);
  * mul_scalar with an int multiplies residues directly, no level consumed;
  * add/sub auto-align levels with mod_drop.

The port runs eagerly: each method is a sequence of torch ops and kernel
launches on the ciphertext's device.  `mul_relin` takes orion_tpu's
default fused ModDown+rescale epilogue, and its two-step branch where the
fused tables do not exist (level 0) or no rescale is asked for.

Batches: a ciphertext's data may carry leading batch axes, (..., 2, L, N):
B ciphertexts that share a level and a scale go through every method as
one, each key-switch kernel launched once over the batch.  orion_tpu maps
its circuit over such ciphertexts one at a time (`lax.map`); modular
arithmetic is exact, so the residues agree item for item.
"""

from __future__ import annotations

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .context import CKKSContext
from .keys import KeyChest
from .keyswitch import (DevLevel, dev_level, keyswitch, mod_drop_rescale,
                        rescale_poly)
from .modops import add_mod, mont_mul, neg_mod, sub_mod, to_mont


class Evaluator:
    def __init__(self, ctx: CKKSContext, keys: KeyChest):
        self.ctx = ctx
        self.keys = keys
        self._key_packs: dict = {}   # lintrans_scan.build_key_pack cache
        self._perms: dict = {}       # Galois element -> device permutation
        # key packs without Shoup companions (bootstrapped configs)
        self.lean_keys = False

    # ------------------------- helpers ------------------------- #

    def _dl(self, level: int) -> DevLevel:
        return dev_level(self.ctx, level)

    def _qp(self, level: int):
        return self._dl(level).q.p[:, None]

    def _align(self, ct0: Ciphertext, ct1: Ciphertext):
        lvl = min(ct0.level, ct1.level)
        return self.mod_drop(ct0, lvl), self.mod_drop(ct1, lvl)

    def _check_scales(self, s0: float, s1: float):
        if abs(s0 - s1) > 1e-6 * max(abs(s0), abs(s1)):
            raise ValueError(f"scale mismatch in add/sub: {s0} vs {s1}")

    @staticmethod
    def _polys(data):
        """(c0, c1) of a ciphertext, batched or not."""
        return data.select(-3, 0), data.select(-3, 1)

    def _const(self, vals) -> torch.Tensor:
        """Per-limb integer constants -> (L, 1) int64 column on device."""
        return self.ctx.to_device(np.asarray(vals, np.int64)[:, None])

    # ------------------------- level management ------------------------- #

    def mod_drop(self, ct: Ciphertext, level: int) -> Ciphertext:
        if level == ct.level:
            return ct
        if level > ct.level:
            raise ValueError(f"cannot mod-raise {ct.level} -> {level}")
        return ct.with_(data=ct.data[..., : level + 1, :].contiguous(),
                        level=level)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        dl = self._dl(ct.level)
        data = rescale_poly(ct.data, dl)
        return Ciphertext(data, ct.level - 1,
                          ct.scale / self.ctx.q_primes[ct.level])

    # ------------------------- add/sub/neg ------------------------- #

    def negate(self, ct: Ciphertext) -> Ciphertext:
        return ct.with_(data=neg_mod(ct.data, self._qp(ct.level)))

    def add(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        ct0, ct1 = self._align(ct0, ct1)
        self._check_scales(ct0.scale, ct1.scale)
        return ct0.with_(data=add_mod(ct0.data, ct1.data, self._qp(ct0.level)))

    def sub(self, ct0: Ciphertext, ct1: Ciphertext) -> Ciphertext:
        ct0, ct1 = self._align(ct0, ct1)
        self._check_scales(ct0.scale, ct1.scale)
        return ct0.with_(data=sub_mod(ct0.data, ct1.data, self._qp(ct0.level)))

    # ------------------------- plaintext ops ------------------------- #

    def _pt_at(self, pt: Plaintext, level: int) -> Plaintext:
        if pt.level < level:
            raise ValueError(f"plaintext level {pt.level} < ct level {level}")
        if pt.level == level:
            return pt
        sl = pt.data[: level + 1]
        sh = pt.shoup[: level + 1] if pt.shoup is not None else None
        return pt.with_(data=sl, shoup=sh, level=level)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        pt = self._pt_at(pt, ct.level)
        self._check_scales(ct.scale, pt.scale)
        c0, c1 = self._polys(ct.data)
        c0 = add_mod(c0, pt.data, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, c1], dim=-3))

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        pt = self._pt_at(pt, ct.level)
        self._check_scales(ct.scale, pt.scale)
        c0, c1 = self._polys(ct.data)
        c0 = sub_mod(c0, pt.data, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, c1], dim=-3))

    def mul_plain(self, ct: Ciphertext, pt: Plaintext,
                  rescale: bool = True) -> Ciphertext:
        # Shoup (pt.shoup present) and Montgomery products both give the
        # exact residue: one plain product serves both
        pt = self._pt_at(pt, ct.level)
        data = ct.data * pt.data % self._qp(ct.level)
        out = Ciphertext(data, ct.level, ct.scale * pt.scale)
        return self.rescale(out) if rescale else out

    # ------------------------- scalar ops ------------------------- #

    def _scalar_pt(self, value: float, scale: float, level: int):
        res = self.ctx.q_primes[: level + 1]
        c = int(round(value * scale))
        return self._const([c % p for p in res])

    def add_scalar(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        const = self._scalar_pt(scalar, ct.scale, ct.level)
        c0, c1 = self._polys(ct.data)
        c0 = add_mod(c0, const, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, c1], dim=-3))

    def sub_scalar(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        return self.add_scalar(ct, -scalar)

    def _mul_const(self, ct: Ciphertext, c: int) -> torch.Tensor:
        res = self.ctx.q_primes[: ct.level + 1]
        return ct.data * self._const([c % p for p in res]) % self._qp(
            ct.level)

    def mul_scalar_int(self, ct: Ciphertext, scalar: int) -> Ciphertext:
        return ct.with_(data=self._mul_const(ct, scalar))

    def mul_scalar_float(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        """Errorless scalar mul: encode at scale q_l, multiply, rescale."""
        ql = self.ctx.q_primes[ct.level]
        data = self._mul_const(ct, int(round(scalar * ql)))
        return self.rescale(Ciphertext(data, ct.level, ct.scale * ql))

    def mul_scalar_at(self, ct: Ciphertext, scalar: float, enc_scale: float,
                      rescale: bool = True) -> Ciphertext:
        """Multiply by a scalar encoded at an explicit scale (polyeval's
        per-term scale targeting).  Result scale = ct.scale*enc_scale
        [/q_l]."""
        data = self._mul_const(ct, int(round(scalar * enc_scale)))
        out = Ciphertext(data, ct.level, ct.scale * enc_scale)
        return self.rescale(out) if rescale else out

    def set_scale(self, ct: Ciphertext, scale: float) -> Ciphertext:
        """Metadata-only scale override (reference Quad `out.set_scale`)."""
        return ct.with_(scale=float(scale))

    def adjust_scale(self, ct: Ciphertext, target_scale: float) -> Ciphertext:
        """Bring ct to ~target_scale exactly-trackably; consumes one level.

        Multiplies by the integer k = round(target*q_l/scale) and rescales,
        so the declared output scale (scale*k/q_l) is the TRUE scale.
        """
        ql = self.ctx.q_primes[ct.level]
        k = max(1, round(target_scale * ql / ct.scale))
        out = self.mul_scalar_int(ct, k).with_(scale=ct.scale * k)
        return self.rescale(out)

    def mul_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        if isinstance(scalar, float) and float(scalar).is_integer():
            scalar = int(scalar)
        if isinstance(scalar, (int, np.integer)):
            return self.mul_scalar_int(ct, int(scalar))
        return self.mul_scalar_float(ct, float(scalar))

    # ------------------------- ct-ct multiply ------------------------- #

    def mul_relin(self, ct0: Ciphertext, ct1: Ciphertext,
                  rescale: bool = True) -> Ciphertext:
        ct0, ct1 = self._align(ct0, ct1)
        lvl = ct0.level
        dl = self._dl(lvl)
        qp = dl.q.p[:, None]
        pinv = dl.q_pinv[:, None]
        rm, rs = dl.q_rmod[:, None], dl.q_rshoup[:, None]
        a0, a1 = self._polys(ct0.data)
        b0, b1 = self._polys(ct1.data)
        m10 = to_mont(b0, rm, rs, qp)
        m11 = to_mont(b1, rm, rs, qp)
        d0 = mont_mul(a0, m10, qp, pinv)
        d1 = add_mod(mont_mul(a0, m11, qp, pinv),
                     mont_mul(a1, m10, qp, pinv), qp)
        d2 = mont_mul(a1, m11, qp, pinv)
        rlk = self.keys.relin_key
        if rescale and dl.dropdown is not None:
            # fused epilogue: accumulate the relin inner product in the
            # extended basis, fold the ciphertext part in as P*d, divide
            # by P*q_l in ONE basis conversion (mod_drop_rescale)
            acc = keyswitch(d2, dl, rlk.data, rlk.shoup, raw=True)
            pd = torch.stack([d0, d1], dim=-3) * dl.p_mod_q % qp
            accq = add_mod(acc[..., : lvl + 1, :], pd, qp)
            acc = torch.cat([accq, acc[..., lvl + 1:, :]], dim=-2)
            data = mod_drop_rescale(acc, dl)
            return Ciphertext(data, lvl - 1,
                              ct0.scale * ct1.scale
                              / self.ctx.q_primes[lvl])
        ks = keyswitch(d2, dl, rlk.data, rlk.shoup)
        k0, k1 = self._polys(ks)
        data = torch.stack([add_mod(d0, k0, qp), add_mod(d1, k1, qp)],
                           dim=-3)
        out = Ciphertext(data, lvl, ct0.scale * ct1.scale)
        return self.rescale(out) if rescale else out

    def square(self, ct: Ciphertext, rescale: bool = True) -> Ciphertext:
        return self.mul_relin(ct, ct, rescale=rescale)

    # ------------------------- automorphisms ------------------------- #

    def _galois_perm(self, k: int) -> torch.Tensor:
        """The NTT-domain permutation of Galois element k on the device,
        copied there once per element: a copy per rotation from pageable
        host memory would synchronise the stream every time."""
        if k not in self._perms:
            self._perms[k] = self.ctx.to_device(
                np.asarray(self.ctx.automorphism_perm(k), np.int64))
        return self._perms[k]

    def _apply_galois(self, ct: Ciphertext, k: int) -> Ciphertext:
        perm = self._galois_perm(k)
        dl = self._dl(ct.level)
        qp = dl.q.p[:, None]
        c0, c1 = self._polys(ct.data)
        c0p, c1p = c0[..., perm], c1[..., perm]
        gk = self.keys.galois_key(k)
        k0, k1 = self._polys(keyswitch(c1p, dl, gk.data, gk.shoup))
        data = torch.stack([add_mod(c0p, k0, qp), k1], dim=-3)
        return ct.with_(data=data)

    def rotate(self, ct: Ciphertext, amount: int) -> Ciphertext:
        amount = amount % self.ctx.slots
        if amount == 0:
            return ct
        return self._apply_galois(ct, self.ctx.galois_element(amount))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        if self.ctx.ring_type == "conjugate_invariant":
            return ct  # slots are real; conjugation is the identity
        return self._apply_galois(ct, self.ctx.galois_element_conj())
