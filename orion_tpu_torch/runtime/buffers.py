"""Device buffers of a compiled net, and `io_mode: stream`.

Counterpart of `orion_tpu/runtime/buffers.py`.  `collect_swappables`
finds every large buffer a leaf module's encrypted forward can read and
gives a swap handle (getter and setter) for each.  Collection is scoped:
a module gets the context's transform tables, its own plaintexts, its
compiled transforms, the level-trimmed key packs it asked for at compile
(`_pack_keys`), the relinearisation key, its output-rotation keys and,
for a `Bootstrap` module, the shared bootstrap circuit of its slot count.
The context tables, the relinearisation key and the bootstrap circuits
are shared by every module and marked `pin_device`.

`io_mode: stream` (`StreamRunner`): right after a module compiles,
`Scheme.compile` spills its buffers that are not `pin_device` to host
memory, pinned for a scheme on `cuda`, so the card holds one module's
working set during compile and not the whole net's.  At inference the
scheme's `module_runner` gives a leaf module's forward its buffers back
under orion_tpu's residency policy (`orion_tpu/runtime/jit.py:143-168`):
spilled buffers are promoted to device residency greedily, in first-touch
order, under a byte budget (`ORION_TPU_TORCH_RESIDENT_MB`, 4096 MB by
default; 0 turns promotion off); a `pin_device` buffer that another
module spilled goes back to the device once; whatever the budget does not
hold is copied to the device (`non_blocking`, from pinned memory, on the
current stream) for the module's forward and dropped when it returns.
orion_tpu passes buffers as arguments of its per-module XLA programs; the
port runs eagerly, so the runner swaps the device copies in around the
forward.  The port keeps no Shoup companions of its plaintexts and
diagonals (its plaintext product is a plain modular product) and six of
orion_tpu's sixteen four-step tables, so its lists lack orion_tpu's
`pts_shoup` and `t4_*_sh` / `t4_*stack` entries.
"""

from __future__ import annotations

import os

import torch

from ..crypto.ciphertext import Plaintext
from .tensors import PlainTensor


class Swappable:
    """One large buffer: `getter()` reads it, `setter(v)` replaces it;
    `save_and_set` / `restore` swap a value in around a forward.
    `pin_device` buffers are shared by every module (context tables,
    relinearisation key, bootstrap circuits) and stream mode never spills
    them."""

    __slots__ = ("getter", "setter", "_saved", "pin_device")

    def __init__(self, getter, setter, pin_device=False):
        self.getter = getter
        self.setter = setter
        self._saved = None
        self.pin_device = pin_device

    def save_and_set(self, value):
        self._saved = self.getter()
        self.setter(value)

    def restore(self):
        self.setter(self._saved)
        self._saved = None


def _attr_swap(obj, attr):
    return Swappable(lambda: getattr(obj, attr),
                     lambda v: setattr(obj, attr, v))


def _plaintensor_swaps(ptensor: PlainTensor):
    out = []
    for i, pt in enumerate(ptensor.plaintexts):
        def make(i=i, field="data"):
            def getter(f=field, i=i):
                return getattr(ptensor.plaintexts[i], f)

            def setter(v, f=field, i=i):
                ptensor.plaintexts[i] = ptensor.plaintexts[i].with_(**{f: v})
            return Swappable(getter, setter)
        out.append(make(i, "data"))
        if pt.shoup is not None:
            out.append(make(i, "shoup"))
    return out


def _plaintext_swaps(owner, attr):
    pt = getattr(owner, attr)
    out = [Swappable(lambda: getattr(owner, attr).data,
                     lambda v: setattr(owner, attr,
                                       getattr(owner, attr).with_(data=v)))]
    if pt.shoup is not None:
        out.append(Swappable(
            lambda: getattr(owner, attr).shoup,
            lambda v: setattr(owner, attr,
                              getattr(owner, attr).with_(shoup=v))))
    return out


def _scan_transform_swaps(tr):
    return [_attr_swap(tr, "pts")]


def _key_pack_swaps(pack):
    out = [_attr_swap(pack, "ksk")]
    if pack.ksk_shoup is not None:
        out.append(_attr_swap(pack, "ksk_shoup"))
    return out


def _ksk_swaps(ksk):
    return [_attr_swap(ksk, "data"), _attr_swap(ksk, "shoup")]


def _bootstrapper_swaps(btp):
    out = []
    for tr in list(btp.cts_transforms) + list(btp.stc_transforms):
        out.extend(_scan_transform_swaps(tr))
    out.extend(_plaintext_swaps(btp, "minus_i_pt"))
    out.extend(_plaintext_swaps(btp, "one_u_pt"))
    out.extend(_plaintext_swaps(btp, "plus_i_pt"))
    packs = btp.ev._key_packs
    for pk in btp.pack_keys:
        if pk in packs:
            out.extend(_key_pack_swaps(packs[pk]))
    # the conjugation key, the one original galois key the circuit needs
    out.extend(_ksk_swaps(btp.scheme.keys.galois_key(
        btp.ctx.galois_element_conj())))
    # the circuit is shared by every Bootstrap module (24 on ResNet-20):
    # it stays on the device
    for sw in out:
        sw.pin_device = True
    return out


def _context_swaps(ctx):
    """The context's transform tables ((n_all, N) each), shared by every
    module."""
    return [Swappable(lambda k=k: ctx.dev[k],
                      lambda v, k=k: ctx.dev.__setitem__(k, v),
                      pin_device=True)
            for k in ("tw", "tw_shoup", "itw", "itw_shoup", *ctx.t4_keys)]


def collect_swappables(scheme, module) -> list[Swappable]:
    """Every large buffer THIS module's he forward may read, in a
    deterministic order (orion_tpu's)."""
    out = list(_context_swaps(scheme.ctx))

    # module-held plaintexts (bias, BN constants, bootstrap prescale/shift)
    for name in sorted(vars(module)):
        val = vars(module)[name]
        if isinstance(val, PlainTensor):
            out.extend(_plaintensor_swaps(val))
        elif isinstance(val, Plaintext):
            out.extend(_plaintext_swaps(module, name))

    # compiled linear transforms + the key packs recorded at compile time
    compiled = getattr(module, "compiled", {})
    for key in sorted(compiled):
        out.extend(_scan_transform_swaps(compiled[key]))
    packs = scheme.evaluator._key_packs
    for pk in getattr(module, "_pack_keys", ()):
        if pk in packs:
            out.extend(_key_pack_swaps(packs[pk]))

    # relinearisation key: any ct-ct multiply, shared by every module
    rl = _ksk_swaps(scheme.keys.relin_key)
    for sw in rl:
        sw.pin_device = True
    out.extend(rl)

    # hybrid-embedding output rotations use original galois keys (roll)
    for i in range(1, getattr(module, "output_rotations", 0) + 1):
        amt = scheme.ctx.slots // (2 ** i)
        out.extend(_ksk_swaps(scheme.keys.galois_key(
            scheme.ctx.galois_element(amt))))

    # Bootstrap modules route through the shared bootstrapper circuit
    if getattr(module, "slot_count", None) is not None and \
            type(module).__name__ == "Bootstrap":
        btp = scheme.bootstrapper.get_for_slots(module.slot_count)
        out.extend(_bootstrapper_swaps(btp))
    return out


def spill_swaps_to_host(scheme, swaps) -> int:
    """Move the buffers of `swaps` that are not `pin_device` to host
    memory (`scheme.module_runner`, a `StreamRunner`, keeps the record);
    returns the bytes spilled."""
    return scheme.module_runner.spill(swaps)


def spill_module_to_host(scheme, module) -> int:
    return spill_swaps_to_host(scheme, collect_swappables(scheme, module))


def buffer_bytes(swaps) -> int:
    return sum(int(v.nbytes) for v in (sw.getter() for sw in swaps)
               if isinstance(v, torch.Tensor))


def hbm_report(scheme, net) -> dict:
    """Bytes of the device buffers each leaf module reads, a buffer shared
    by several modules counted with the first of them (wherever it lives
    now: on the device, or spilled to the host)."""
    seen = set()
    per_module = {}
    total = 0
    for name, module in net.named_modules():
        if not module.is_leaf():
            continue
        mod_total = 0
        for sw in collect_swappables(scheme, module):
            v = sw.getter()
            if not isinstance(v, torch.Tensor) or id(v) in seen:
                continue
            seen.add(id(v))
            mod_total += int(v.nbytes)
        per_module[name] = mod_total
        total += mod_total
    return {"total": total, "per_module": per_module}


class StreamRunner:
    """`io_mode: stream`: spills buffers at compile and is the scheme's
    `module_runner` at inference (see the module docstring).

    `host` maps id -> each spilled buffer's host tensor (the record of
    what is spilled); `resident_bytes` counts what was promoted against
    `budget` (bytes: ORION_TPU_TORCH_RESIDENT_MB megabytes of 10^6 bytes,
    as orion_tpu's ORION_TPU_RESIDENT_MB; `promoted` lists the promotions
    in order as (module name, bytes)), `uploaded_bytes` the transient
    copies made since it was last set to 0."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.device = scheme.ctx.device
        self.budget = float(os.environ.get("ORION_TPU_TORCH_RESIDENT_MB",
                                           "4096")) * 1e6
        self.host: dict[int, torch.Tensor] = {}
        self.resident_bytes = 0
        self.uploaded_bytes = 0
        self.promoted: list[tuple] = []
        self._swaps: dict[int, list] = {}

    def is_spilled(self, v) -> bool:
        return self.host.get(id(v)) is v

    def _to_host(self, v: torch.Tensor) -> torch.Tensor:
        """A host copy of v: pinned for a scheme on the card (a copy from
        pageable memory would make every upload synchronous)."""
        pin = self.device.type == "cuda"
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        if pin and not host.is_pinned():
            raise RuntimeError("io_mode stream: pinned host allocation of "
                               f"{v.nbytes} bytes failed")
        host.copy_(v)
        return host

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(host, device=self.device).copy_(
            host, non_blocking=True)

    def spill(self, swaps) -> int:
        moved = 0
        for sw in swaps:
            v = sw.getter()
            if sw.pin_device or not isinstance(v, torch.Tensor) \
                    or self.is_spilled(v):
                continue
            host = self._to_host(v)
            sw.setter(host)
            self.host[id(host)] = host
            moved += int(host.nbytes)
        return moved

    def _unspill(self, sw) -> torch.Tensor:
        host = sw.getter()
        dev = self._to_device(host)
        sw.setter(dev)
        del self.host[id(host)]
        return dev

    def __call__(self, module, args):
        key = id(module)
        if key not in self._swaps:
            self._swaps[key] = collect_swappables(self.scheme, module)
        swaps = self._swaps[key]
        name = getattr(module, "name", None) or type(module).__name__
        for sw in swaps:
            if not self.is_spilled(sw.getter()):
                continue
            if sw.pin_device:
                self._unspill(sw)
                continue
            nbytes = int(sw.getter().nbytes)
            if self.resident_bytes + nbytes <= self.budget:
                self._unspill(sw)
                self.resident_bytes += nbytes
                self.promoted.append((name, nbytes))
        swapped = []
        try:
            for sw in swaps:
                v = sw.getter()
                if self.is_spilled(v):
                    sw.save_and_set(self._to_device(v))
                    swapped.append(sw)
                    self.uploaded_bytes += int(v.nbytes)
            return module.forward(*args)
        finally:
            for sw in reversed(swapped):
                sw.restore()
