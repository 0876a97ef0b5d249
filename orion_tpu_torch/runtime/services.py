"""Backend service layer: encoder, encryptor, LT evaluator, polynomial
evaluator and bootstrapper.

Counterpart of `orion_tpu/runtime/services.py`.  These wrap the crypto
layer with multi-ciphertext semantics and compile-time key management.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from ..crypto import lintrans_scan, placement
from ..crypto.ciphertext import Ciphertext, Plaintext
from ..crypto.polyeval import Polynomial, evaluate_polynomial
from .tensors import CipherTensor, PlainTensor


class EncoderService:
    """Splits arbitrary-length vectors into ceil(numel/slots) plaintexts."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.enc = scheme.enc  # crypto Encoder

    def encode(self, values, level=None, scale=None,
               on_shape=None) -> PlainTensor:
        ctx = self.scheme.ctx
        if hasattr(values, "detach"):
            values = values.detach().cpu().numpy()
        values = np.asarray(values, dtype=np.float64)
        shape = values.shape
        flat = values.reshape(-1)
        slots = ctx.slots
        num_pt = max(1, math.ceil(flat.size / slots))
        padded = np.zeros(num_pt * slots)
        padded[: flat.size] = flat
        if level is None:
            level = self.scheme.input_level_default
        pts = []
        for i in range(num_pt):
            chunk = padded[i * slots:(i + 1) * slots]
            data, s = self.enc.encode(chunk, level=level, scale=scale)
            pts.append(Plaintext(placement.buffer(data, ctx.device), None,
                                 level, s))
        return PlainTensor(self.scheme, pts, shape, on_shape or shape)

    def decode(self, ptensor: PlainTensor) -> np.ndarray:
        vals = []
        for pt in ptensor.plaintexts:
            raw = pt.data.cpu().numpy()
            vals.append(self.enc.decode(raw, pt.scale))
        flat = np.concatenate(vals)
        numel = int(np.prod(ptensor.on_shape))
        return flat[:numel].reshape(ptensor.on_shape)

    def get_moduli_chain(self):
        return self.scheme.ctx.moduli_chain()


class EncryptorService:
    """Per-plaintext encrypt/decrypt loops (host crypto, device tensors)."""

    def __init__(self, scheme):
        self.scheme = scheme

    def encrypt(self, ptensor: PlainTensor) -> CipherTensor:
        keys = self.scheme.keys
        dev = self.scheme.ctx.device
        cts = []
        for pt in ptensor.plaintexts:
            ct = keys.encrypt_rns(pt.data.cpu().numpy())
            cts.append(Ciphertext(placement.buffer(ct, dev), pt.level,
                                  pt.scale))
        return CipherTensor(self.scheme, cts, ptensor.shape,
                            ptensor.on_shape)

    def decrypt(self, ctensor: CipherTensor) -> PlainTensor:
        keys = self.scheme.keys
        dev = self.scheme.ctx.device
        pts = []
        for ct in ctensor.cts:
            raw = keys.decrypt_rns(ct.data.cpu().numpy())
            pts.append(Plaintext(placement.buffer(raw, dev), None,
                                 ct.level, ct.scale))
        return PlainTensor(self.scheme, pts, ctensor.shape,
                           ctensor.on_shape)


class LTEvaluatorService:
    """Compile + evaluate blocked BSGS transforms; generates the
    consolidated rotation-key set at compile time."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.generated_rotations: set[int] = set()

    def layer_rotations(self, layer) -> set:
        """The rotation amounts `generate_transforms` makes keys for:
        every block's BSGS steps and the hybrid output rotations."""
        slots = self.scheme.ctx.slots
        rotations = set()
        for diags in layer.diagonals.values():
            rotations |= lintrans_scan.bsgs_rotations(diags, slots,
                                                      layer.bsgs_ratio)
        for i in range(1, layer.output_rotations + 1):
            rotations.add(slots // (2 ** i))
        return rotations

    def generate_transforms(self, layer):
        ctx = self.scheme.ctx
        compiled = {
            block: lintrans_scan.compile_transform_scan(
                self.scheme.enc, diags, layer.level, ctx.slots,
                layer.bsgs_ratio)
            for block, diags in layer.diagonals.items()}
        self.generate_rotation_keys(self.layer_rotations(layer))
        layer.compiled = compiled
        self._prewarm_key_packs(compiled, layer)
        return compiled

    def _prewarm_key_packs(self, compiled, layer):
        """Build the level-trimmed KeyPacks evaluation will request, at
        compile time, so evaluation never regenerates keys.  Records the
        packs' cache keys on the layer (`_pack_keys`) for the scoped
        buffer collection of `runtime/buffers.py`."""
        ev = self.scheme.evaluator
        packs = []
        cols = {}
        for (i, j), tr in compiled.items():
            cols.setdefault(j, set()).update(set(tr.babies) | {0})
            giants = [a for a in tr.giants if a != 0]
            if giants:
                packs.append(lintrans_scan.build_key_pack(ev, giants,
                                                          level=tr.level))
        for j, babies in cols.items():
            todo = [a for a in sorted(babies) if a != 0]
            if todo:
                level = next(tr.level for (i, jj), tr in compiled.items()
                             if jj == j)
                packs.append(lintrans_scan.build_key_pack(ev, todo,
                                                          level=level))
        layer._pack_keys = tuple(sorted(
            {pk.cache_key for pk in packs},
            key=lambda k: (k[0], -1 if k[1] is None else k[1])))

    def generate_rotation_keys(self, rotations):
        # sorted: the generation order fixes every later RNG draw
        new = set(rotations) - self.generated_rotations
        for r in sorted(new):
            self.scheme.keys.rotation_key(r)
        self.generated_rotations |= new

    def evaluate_transforms(self, layer, in_ctensor: CipherTensor):
        ev = self.scheme.evaluator
        rows = max(r for (r, c) in layer.compiled) + 1
        outs = lintrans_scan.eval_transform_blocked_scan(
            ev, layer.compiled, in_ctensor.cts, rows)
        return CipherTensor(self.scheme, outs, layer.output_shape,
                            layer.fhe_output_shape)


class PolyEvaluatorService:
    """Polynomial objects, their evaluation over a CipherTensor, and the
    minimax sign coefficients."""

    def __init__(self, scheme):
        self.scheme = scheme
        self._minimax_cache = {}

    def generate_monomial(self, coeffs):
        return Polynomial(list(coeffs), "monomial")

    def generate_chebyshev(self, coeffs):
        return Polynomial(list(coeffs), "chebyshev")

    def evaluate_polynomial(self, ctensor: CipherTensor, poly: Polynomial,
                            output_scale=None) -> CipherTensor:
        """One circuit over every ciphertext of the tensor: members that
        share (level, scale) are stacked on a batch axis, so each kernel
        launch covers them all (orion_tpu maps its circuit over them one
        at a time with `lax.map`); the results are equal item for item."""
        ev = self.scheme.evaluator
        cts = ctensor.cts
        same_meta = len(cts) > 1 and all(
            c.level == cts[0].level and c.scale == cts[0].scale
            for c in cts[1:])
        if same_meta:
            stacked = cts[0].with_(data=torch.stack([c.data for c in cts]))
            out = evaluate_polynomial(ev, stacked, poly, output_scale)
            outs = [out.with_(data=d) for d in out.data.unbind(0)]
        else:
            outs = [evaluate_polynomial(ev, ct, poly, output_scale)
                    for ct in cts]
        return CipherTensor(self.scheme, outs, ctensor.shape,
                            ctensor.on_shape)

    def generate_minimax_sign_coeffs(self, degrees, prec=128, logalpha=6,
                                     logerr=12):
        from ..crypto.minimax import generate_minimax_sign_coeffs
        key = (tuple(degrees), prec, logalpha, logerr)
        if key not in self._minimax_cache:
            self._minimax_cache[key] = generate_minimax_sign_coeffs(
                list(degrees), prec, logalpha, logerr)
        return self._minimax_cache[key]


class BootstrapperService:
    """Per-slot-count bootstrappers: tensors occupying s < slots get an
    s-point circuit whose CtS/StC stages are cheaper (sparse
    bootstrapping)."""

    def __init__(self, scheme):
        self.scheme = scheme
        self._by_slots: dict[int, object] = {}

    def _slot_key(self, slot_count) -> int:
        ctx = self.scheme.ctx
        p = self.scheme.params
        if not slot_count:
            return ctx.slots
        s = min(int(slot_count), ctx.slots)
        if p.boot:
            # the circuit needs >= one butterfly stage per grouped level
            s = max(s, 1 << max(p.boot["CtSLevels"], p.boot["StCLevels"]))
        return s

    def _build(self, s: int):
        from ..crypto.bootstrap import Bootstrapper
        p = self.scheme.params
        if not p.boot:
            raise ValueError(
                "this network needs bootstrapping: add a `boot_params:` "
                "section to the config so circuit primes are provisioned")
        return Bootstrapper(
            self.scheme,
            slots=s,
            cts_levels=p.boot["CtSLevels"],
            stc_levels=p.boot["StCLevels"],
            mod_degree=p.boot["ModDegree"],
            K=p.boot["K"])

    def generate_bootstrapper(self, slot_count):
        return self.get_for_slots(slot_count)

    def get_for_slots(self, slot_count):
        """The bootstrapper instance serving a given sparse slot count."""
        s = self._slot_key(slot_count)
        if s not in self._by_slots:
            self._by_slots[s] = self._build(s)
        return self._by_slots[s]

    def bootstrap(self, ct, slots):
        return self.get_for_slots(slots).bootstrap(ct, slots)
