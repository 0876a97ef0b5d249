"""CKKS bootstrapping: ModRaise -> CoeffsToSlots -> EvalMod -> SlotsToCoeffs.

Counterpart of `orion_tpu/crypto/bootstrap.py`, the same circuit step for
step, so the refreshed ciphertexts agree bit for bit:
  1. ModRaise: the exhausted ciphertext's bottom-modulus residues are
     lifted to the full RNS chain (inverse NTT of the base rows, one basis
     conversion, forward NTT of every Q row), after an exact integer
     prescale to Delta_boot = D*Delta (MessageRatio);
  2. CtS: the inverse special-FFT butterfly chain (homdft.py) as grouped
     BSGS transforms with complex diagonals; one conjugation splits the
     coefficient halves into two real-valued ciphertexts;
  3. EvalMod: Chebyshev approximation of (1/2pi(K+1)) sin(2pi(K+1) y) in
     hi-scale mode (two rescales per multiplication at the wide working
     scale), the beta and sparse ratio folded into the coefficients;
  4. StC: the forward butterfly chain; recombination u + i*v is one
     complex plaintext multiplication.

The circuit consumes its own primes appended ABOVE the user's LogQ chain
(config `boot_params`), so a bootstrap returns the ciphertext to the top
of the user chain.  On the card every step runs the port's kernels: the
NTT pair in ModRaise, and the key-switch and rescale kernels in the
transforms, the conjugation and EvalMod.  The port runs the phases
eagerly, one after another (orion_tpu's per-phase program cache,
`PhaseRunner`, has no counterpart), and evaluates EvalMod once over u and
v stacked on a batch axis where orion_tpu makes two calls.  A ciphertext
whose data carry query axes, (..., 2, L, N), goes through every phase as
one: B queries' bootstraps share each launch (u/v stacked to (2, ...)).

Value bookkeeping (x = message values, c = Delta*x + q0*I after raise):
  CtS matrices carry alpha = 0.5 * Delta / (q0 (K+1))  => u, v hold
      y = (Delta x + q0 I) / (q0 (K+1)) in [-1, 1];
  EvalMod(y) ~ Delta x / (q0 (K+1));
  StC matrices carry beta = q0 (K+1) / Delta  => output values = x.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import homdft, placement
from .ciphertext import Ciphertext, Plaintext
from .keyswitch import _dev_digit, dev_level, fbc, ring_intt, ring_ntt
from .lintrans_scan import (baby_rotation_cache, build_key_pack,
                            compile_transform_scan, eval_transform_scan,
                            rotate_scan)
from .polyeval import Polynomial, evaluate_polynomial, hi_scale_depth


def fit_eval_mod(K: int, degree: int):
    """Chebyshev coefficients of (1/(2pi(K+1))) * sin(2pi(K+1) y), y in [-1,1]."""
    fn = lambda y: np.sin(2 * np.pi * (K + 1) * y) / (2 * np.pi * (K + 1))
    return np.polynomial.chebyshev.chebinterpolate(fn, degree)


class Bootstrapper:
    """Full- or sparse-slot bootstrapping circuit.

    With `slots` = s < ctx.slots the circuit runs on the 2s-coefficient
    subring: after ModRaise a partial trace (log2(n/s) rotate-adds)
    projects the plaintext onto subring-supported coefficients, multiplying
    them by n/s (absorbed into the declared scale), and CtS/StC become
    s-point special FFTs with period-tiled diagonals.  The output carries
    the s slots replicated n/s times.
    """

    def __init__(self, scheme, slots: int | None = None, cts_levels: int = 3,
                 stc_levels: int = 3, mod_degree: int = 255, K: int = 16):
        self.scheme = scheme
        self.ctx = scheme.ctx
        self.ev = scheme.evaluator
        self.enc = scheme.enc
        self.K = K
        self.cts_levels = cts_levels
        self.stc_levels = stc_levels
        self.mod_degree = mod_degree

        ctx = self.ctx
        if ctx.ring_type != "standard":
            raise NotImplementedError(
                "bootstrapping is implemented for the standard ring only")
        p = scheme.params
        self.n = ctx.slots
        # sparse slot count: at least one butterfly stage per grouped level
        s = int(slots) if slots else ctx.slots
        s = max(s, 1 << max(cts_levels, stc_levels))
        self.slots = min(s, ctx.slots)
        self.ratio = self.n // self.slots
        self.user_top = p.base_level + p.l_eff     # bootstrap output level
        self.top = ctx.max_level                   # after ModRaise
        self.q0 = float(np.prod([ctx.q_primes[i]
                                 for i in range(p.base_level + 1)],
                                dtype=np.float64))
        delta = ctx.default_scale

        # hi-scale EvalMod: two rescales per multiplication level (+1 for
        # the chunked-PS coefficient multiply at realistic degrees)
        mod_depth = hi_scale_depth(mod_degree)
        need = cts_levels + 1 + mod_depth + 1 + stc_levels
        budget = self.top - self.user_top
        if budget < need:
            raise ValueError(
                f"bootstrap circuit needs {need} levels above the user chain "
                f"but only {budget} are available; extend boot_params")

        # MessageRatio: the message is prescaled UP by the exact integer
        # D = round(q0/(R*Delta)) before ModRaise, so it occupies 1/R of
        # the EvalMod band however wide q0 is; EvalMod-input errors reach
        # the output multiplied by beta = q0(K+1)/(D*Delta) ~ R(K+1)
        boot_cfg = p.boot or {}
        R = int(boot_cfg.get("MsgRatio", 256))
        self.msg_ratio = R
        self.D = max(1, int(round(self.q0 / (R * delta))))
        self.delta_boot = self.D * delta
        self.beta = self.q0 * (K + 1) / self.delta_boot
        # extra message headroom the nn.Bootstrap module must provide when
        # D cannot reach the target ratio (q0 too narrow): a power of two
        self.headroom = 1
        while self.q0 / self.delta_boot * self.headroom < R * 0.75:
            self.headroom <<= 1

        # Scale plan: entering CtS the raised ciphertext's scale is
        # re-declared as q0*(K+1)*ratio, and each CtS stage grows the
        # working scale through its plaintext scale until EvalMod runs at
        # W = 2^(2*CircuitLogQ); the extra boost q_ext/m is shed through
        # the u/v extraction constants, encoded at the small integer
        # scale m (exact coefficients).
        self.pre_scale = self.q0 * (K + 1) * self.ratio
        circuit_logq = int(boot_cfg.get("CircuitLogQ", p.logscale))
        work_target = float(2.0 ** (2 * circuit_logq))
        self.extract_m = 1 << 6
        lvl_ext = self.top - cts_levels           # u/v extraction level
        q_ext = float(ctx.q_primes[lvl_ext])
        growth = (work_target * q_ext /
                  (self.extract_m * self.pre_scale)) ** (1.0 / cts_levels)

        # ---- CtS transforms (0.5 folded for the conjugation split) ----
        cts_mats = homdft.cts_matrices(self.slots, cts_levels, 0.5)
        self.cts_transforms = []
        rotations = set()
        lvl = self.top
        s_track = self.pre_scale
        for mat in cts_mats:
            diags = self._tiled_diagonals(mat)
            tr = compile_transform_scan(
                self.enc, diags, lvl, self.n,
                pt_scale=float(ctx.q_primes[lvl]) * growth)
            self.cts_transforms.append(tr)
            rotations |= set(tr.babies) | {a for a in tr.giants if a}
            s_track *= growth
            lvl -= 1
        self.lvl_after_cts = lvl
        self.cts_out_scale = s_track                  # = W * q_ext / m
        self.mod_in_scale = s_track * self.extract_m / q_ext

        # ---- EvalMod polynomial: beta and the sparse ratio folded into
        # the coefficients (coefficient quantisation is absolute) ----
        fold = self.beta * self.ratio
        self.mod_poly = Polynomial(
            (fit_eval_mod(K, mod_degree) * fold).tolist(), "chebyshev")

        # ---- StC transforms: each stage sheds (W/Delta)^(1/levels) ----
        lvl_stc = self.lvl_after_cts - 1 - mod_depth - 1
        stc_mats = homdft.stc_matrices(self.slots, stc_levels, 1.0)
        self.stc_transforms = []
        lvl = lvl_stc
        shed = (self.mod_in_scale / delta) ** (1.0 / stc_levels)
        for mat in stc_mats:
            diags = self._tiled_diagonals(mat)
            tr = compile_transform_scan(
                self.enc, diags, lvl, self.n,
                pt_scale=float(ctx.q_primes[lvl]) / shed)
            self.stc_transforms.append(tr)
            rotations |= set(tr.babies) | {a for a in tr.giants if a}
            lvl -= 1
        if lvl < self.user_top:
            raise ValueError("bootstrap level plan underflows the user chain")
        self.out_level = lvl

        # subring trace rotations (doubling ladder): amounts s, 2s, 4s, ...
        self.trace_amounts = [self.slots * (1 << t)
                              for t in range(int(math.log2(self.ratio)))]
        rotations |= set(self.trace_amounts)

        # rotation + conjugation keys, and the level-trimmed key packs the
        # circuit uses (built here so evaluation never makes a key); their
        # cache keys scope the circuit's buffers (runtime/buffers.py)
        scheme.lt_evaluator.generate_rotation_keys(rotations)
        scheme.keys.galois_key(ctx.galois_element_conj())
        self.trace_packs = [build_key_pack(self.ev, [amt], level=self.top)
                            for amt in self.trace_amounts]
        packs = list(self.trace_packs)
        for tr in self.cts_transforms + self.stc_transforms:
            for steps in (tr.babies, tr.giants):
                amounts = [a for a in steps if a != 0]
                if amounts:
                    packs.append(build_key_pack(self.ev, amounts,
                                                level=tr.level))
        self.pack_keys = tuple(sorted(
            {pk.cache_key for pk in packs},
            key=lambda k: (k[0], -1 if k[1] is None else k[1])))

        # conjugation-split constants.  mod_depth is an upper BOUND on
        # EvalMod's consumption; _recombine mod-drops to this planned level
        # so the pre-encoded constants always align
        self.lvl_mod_out = self.lvl_after_cts - 1 - mod_depth
        m = float(self.extract_m)
        self.minus_i_pt = self._make_const_pt(-1.0j, self.lvl_after_cts,
                                              scale=m)
        self.one_u_pt = self._make_const_pt(1.0, self.lvl_after_cts, scale=m)
        self.plus_i_pt = self._make_const_pt(1.0j, self.lvl_mod_out)

        # ModRaise tables: FBC from the bottom block to the full chain
        base_idx = list(range(p.base_level + 1))
        full_idx = list(range(ctx.n_q))
        self._raise_digit = _dev_digit(
            ctx._digit_tables(base_idx, full_idx), ctx)

    # ------------------------------------------------------------ #

    def _tiled_diagonals(self, mat):
        """Generalised diagonals of an s-point stage matrix, tiled to the
        full slot count (an s-periodic vector rotates identically within
        every period)."""
        diags = homdft.matrix_diagonals(mat)
        if self.ratio == 1:
            return diags
        return {d: np.tile(v, self.ratio) for d, v in diags.items()}

    def _subring_trace(self, ct: Ciphertext) -> Ciphertext:
        """sum_t rot(ct, t*s) via the doubling ladder: kills plaintext
        coefficients outside the 2s-subring and multiplies the survivors by
        ratio (declared into the scale)."""
        ev = self.ev
        for pack in self.trace_packs:
            rot = rotate_scan(ev, ct, pack)[0]
            ct = ev.add(ct, Ciphertext(rot, ct.level, ct.scale))
        return ct

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Lift residues mod the q0 block to the full chain (adds q0*I):
        one inverse NTT of the base rows of both polys, one basis
        conversion of their 2N columns (of every query of a batch), one
        forward NTT of every Q row."""
        ctx = self.ctx
        base = self.scheme.params.base_level
        dl_b = dev_level(ctx, base)
        dl_t = dev_level(ctx, self.top)
        # (..., 2, base+1, N), `...` the query axes of a batch
        coeff = ring_intt(ct.data[..., : base + 1, :], dl_b.q)
        cols = coeff.movedim(-2, 0).reshape(base + 1, -1)
        lifted = fbc(cols, self._raise_digit, dl_t.q.p[:, None])
        lifted = lifted.reshape((ctx.n_q,) + tuple(coeff.shape[:-2])
                                + (ctx.n,)).movedim(0, -2)
        raised = ring_ntt(lifted, dl_t.q)
        return Ciphertext(raised, self.top, ct.scale)

    def _make_const_pt(self, value: complex, level: int,
                       scale: float | None = None) -> Plaintext:
        """Constant complex vector encoded at scale q_l (errorless level
        consumption) or an explicit integer scale (exact coefficients)."""
        s = float(self.ctx.q_primes[level]) if scale is None else scale
        vec = np.full(self.n, value, dtype=np.complex128)
        data, scale = self.enc.encode(vec, level=level, scale=s)
        return Plaintext(placement.buffer(data, self.ctx.device), None,
                         level, scale)

    # ---------------- pipeline phases ---------------- #

    def _pre(self, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        if self.D > 1:
            # exact integer prescale to Delta_boot = D*Delta ~ q0/R
            ct = ev.mul_scalar_int(ct, self.D)
        raised = self.mod_raise(ct)
        if self.ratio > 1:
            raised = self._subring_trace(raised)
        # free division into the EvalMod band: re-declare the scale
        return raised.with_(scale=self.pre_scale)

    def _one_chain(self, ct: Ciphertext, tr) -> Ciphertext:
        ev = self.ev
        rots = baby_rotation_cache(ev, ct, set(tr.babies) | {0})
        return ev.rescale(eval_transform_scan(ev, tr, ct, rots))

    def _extract(self, t: Ciphertext):
        ev = self.ev
        t_conj = ev.conjugate(t)
        # u/v extraction: exact-integer-scale constants shed the CtS pt
        # boost (scale W*q_ext/m -> W), consuming the planned level
        u = ev.mul_plain(ev.add(t, t_conj), self.one_u_pt)    # 2*Re
        v = ev.mul_plain(ev.sub(t, t_conj), self.minus_i_pt)  # Im part
        return u, v

    def _evalmod(self, x: Ciphertext) -> Ciphertext:
        return evaluate_polynomial(self.ev, x, self.mod_poly, hi_scale=True)

    def _recombine(self, u: Ciphertext, v: Ciphertext) -> Ciphertext:
        ev = self.ev
        v = ev.mod_drop(v, self.lvl_mod_out)
        # a0 = u + i v (beta*ratio already folded into the EvalMod
        # coefficients, so a0 holds the refreshed coefficients directly)
        iv = ev.mul_plain(v, self.plus_i_pt)
        return ev.add(ev.mod_drop(u, iv.level), iv)

    def bootstrap(self, ct: Ciphertext, slots: int | None = None) -> Ciphertext:
        """Refresh an exhausted ciphertext to the top of the user chain."""
        if ct.level < self.scheme.params.base_level:
            raise ValueError(
                f"bootstrap input level {ct.level} below the modulus floor")
        t = self._pre(ct)
        for tr in self.cts_transforms:
            t = self._one_chain(t, tr)
        u, v = self._extract(t)
        # u and v share a level and a scale: one EvalMod over the pair
        uv = self._evalmod(u.with_(data=torch.stack([u.data, v.data])))
        a0 = self._recombine(uv.with_(data=uv.data[0]),
                             uv.with_(data=uv.data[1]))
        for tr in self.stc_transforms:
            a0 = self._one_chain(a0, tr)
        return a0.with_(scale=ct.scale)
