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
"""

from __future__ import annotations

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .context import CKKSContext
from .keys import KeyChest
from .keyswitch import (DevLevel, dev_level, keyswitch, ks_decompose,
                        ks_finish_raw, mod_drop_rescale, rescale_poly)
from .modops import add_mod, mont_mul, neg_mod, sub_mod, to_mont


class Evaluator:
    def __init__(self, ctx: CKKSContext, keys: KeyChest):
        self.ctx = ctx
        self.keys = keys
        self._key_packs: dict = {}   # lintrans_scan.build_key_pack cache

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

    def _const(self, vals) -> torch.Tensor:
        """Per-limb integer constants -> (L, 1) int64 column on device."""
        return self.ctx.to_device(np.asarray(vals, np.int64)[:, None])

    # ------------------------- level management ------------------------- #

    def mod_drop(self, ct: Ciphertext, level: int) -> Ciphertext:
        if level == ct.level:
            return ct
        if level > ct.level:
            raise ValueError(f"cannot mod-raise {ct.level} -> {level}")
        return ct.with_(data=ct.data[:, : level + 1].contiguous(),
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
        c0 = add_mod(ct.data[0], pt.data, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, ct.data[1]]))

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        pt = self._pt_at(pt, ct.level)
        self._check_scales(ct.scale, pt.scale)
        c0 = sub_mod(ct.data[0], pt.data, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, ct.data[1]]))

    def mul_plain(self, ct: Ciphertext, pt: Plaintext,
                  rescale: bool = True) -> Ciphertext:
        # Shoup (pt.shoup present) and Montgomery products both give the
        # exact residue: one plain product serves both
        pt = self._pt_at(pt, ct.level)
        data = ct.data * pt.data[None] % self._qp(ct.level)
        out = Ciphertext(data, ct.level, ct.scale * pt.scale)
        return self.rescale(out) if rescale else out

    # ------------------------- scalar ops ------------------------- #

    def _scalar_pt(self, value: float, scale: float, level: int):
        res = self.ctx.q_primes[: level + 1]
        c = int(round(value * scale))
        return self._const([c % p for p in res])

    def add_scalar(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        const = self._scalar_pt(scalar, ct.scale, ct.level)
        c0 = add_mod(ct.data[0], const, self._qp(ct.level))
        return ct.with_(data=torch.stack([c0, ct.data[1]]))

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
        m10 = to_mont(ct1.data[0], rm, rs, qp)
        m11 = to_mont(ct1.data[1], rm, rs, qp)
        d0 = mont_mul(ct0.data[0], m10, qp, pinv)
        d1 = add_mod(mont_mul(ct0.data[0], m11, qp, pinv),
                     mont_mul(ct0.data[1], m10, qp, pinv), qp)
        d2 = mont_mul(ct0.data[1], m11, qp, pinv)
        rlk = self.keys.relin_key
        if rescale and dl.dropdown is not None:
            # fused epilogue: accumulate the relin inner product in the
            # extended basis, fold the ciphertext part in as P*d, divide
            # by P*q_l in ONE basis conversion (mod_drop_rescale)
            ext = ks_decompose(d2, dl)
            acc = ks_finish_raw(ext, dl, rlk.data, rlk.shoup)
            pd = torch.stack([d0, d1]) * dl.p_mod_q % qp
            accq = add_mod(acc[:, : lvl + 1], pd, qp)
            acc = torch.cat([accq, acc[:, lvl + 1:]], dim=1)
            data = mod_drop_rescale(acc, dl)
            return Ciphertext(data, lvl - 1,
                              ct0.scale * ct1.scale
                              / self.ctx.q_primes[lvl])
        ks = keyswitch(d2, dl, rlk.data, rlk.shoup)
        data = torch.stack([add_mod(d0, ks[0], qp), add_mod(d1, ks[1], qp)])
        out = Ciphertext(data, lvl, ct0.scale * ct1.scale)
        return self.rescale(out) if rescale else out

    def square(self, ct: Ciphertext, rescale: bool = True) -> Ciphertext:
        return self.mul_relin(ct, ct, rescale=rescale)

    # ------------------------- automorphisms ------------------------- #

    def _apply_galois(self, ct: Ciphertext, k: int) -> Ciphertext:
        perm = torch.as_tensor(self.ctx.automorphism_perm(k),
                               dtype=torch.long, device=ct.data.device)
        dl = self._dl(ct.level)
        qp = dl.q.p[:, None]
        c0p = ct.data[0][..., perm]
        c1p = ct.data[1][..., perm]
        gk = self.keys.galois_key(k)
        ks = keyswitch(c1p, dl, gk.data, gk.shoup)
        data = torch.stack([add_mod(c0p, ks[0], qp), ks[1]])
        return ct.with_(data=data)

    def rotate(self, ct: Ciphertext, amount: int) -> Ciphertext:
        amount = amount % self.ctx.slots
        if amount == 0:
            return ct
        return self._apply_galois(ct, self.ctx.galois_element(amount))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        return self._apply_galois(ct, self.ctx.galois_element_conj())
