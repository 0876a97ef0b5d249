"""Module system for encrypted networks on `torch.nn.Module`.

Counterpart of `orion_tpu/nn/module.py`: modules carry the FHE metadata
(level, depth, fused, he_mode) and switch between cleartext torch ops and
encrypted evaluation with `.he()` / `.eval()`.  Parameters are
`torch.nn.Parameter`s and running statistics are buffers, so `state_dict`
and `load_state_dict` work as usual; `models.load_jax_params` fills them
from a numpy dict.

`__call__` is orion's, not torch's: under the compiler's tracer a leaf
call becomes a DAG node, in he mode ciphertext inputs are first dropped
to the solver-assigned level, a leaf's forward goes through the scheme's
`module_runner` where one is set (`io_mode: stream` brings the module's
spilled buffers back to the device around it, `runtime/buffers.py`), a
bootstrap the placer attached (`post_bootstrap`) runs after the module's
forward, and then `Module.output_hook`, if set, sees the leaf's output.
`compile()` is the FHE compile of the module (it replaces
torch.nn.Module.compile).
`Sequential` and `ModuleList` are orion's containers (never leaves, so an
empty `Sequential` is an identity shortcut of a residual block).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """Cleartext activations (torch tensor or array-like) -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_tensor(x) -> torch.Tensor:
    """Cleartext input -> float32 CPU tensor (cleartext math runs on the
    host, as client-side statistics fitting does)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


class Module(torch.nn.Module):
    scheme = None
    margin = None
    # optional observer called as hook(module, out) after every leaf call,
    # in clear and in he mode, after the leaf's post_bootstrap (whose own
    # call fires first): the noise profiler (diagnostics.py) decrypts and
    # compares there without changing the execution path
    output_hook = None

    def __init__(self):
        super().__init__()
        self.level = None
        self.depth = None
        self.fused = False
        self.he_mode = False
        self.name = None

    def is_leaf(self) -> bool:
        if isinstance(self, (Sequential, ModuleList)):
            return False
        # an auto-placed Bootstrap registers as a child but runs after the
        # module, outside its forward: it does not demote its host
        return not any(k != "post_bootstrap" for k in self._modules)

    # ----------------- scheme / modes ----------------- #

    @staticmethod
    def set_scheme(scheme):
        Module.scheme = scheme

    @staticmethod
    def set_margin(margin):
        Module.margin = margin

    def _set_mode_for_all(self, he_mode=False, training=True):
        for m in self.modules():
            m.training = training
            m.he_mode = he_mode

    def train(self, mode=True):
        self._set_mode_for_all(he_mode=False, training=mode)
        return self

    def eval(self):
        self._set_mode_for_all(he_mode=False, training=False)
        return self

    def he(self):
        self._set_mode_for_all(he_mode=True, training=False)
        return self

    def compile(self):
        """FHE compile of this module: encode its plaintexts and keys at
        its assigned level (nothing for modules without constants)."""

    def set_depth(self, depth):
        self.depth = depth

    def set_level(self, level):
        self.level = level

    # ----------------- call / trace ----------------- #

    def __call__(self, *args):
        from ..compiler.tracer import active_tracer
        tr = active_tracer()
        if tr is not None and self.is_leaf():
            return tr.run_leaf(self, args)
        if self.he_mode and self.level is not None:
            # align ciphertext inputs DOWN to the solver-assigned input
            # level, so the runtime level trajectory equals the plan
            args = tuple(
                a.mod_drop(self.level)
                if hasattr(a, "mod_drop") and callable(getattr(a, "level",
                                                               None))
                and a.level() > self.level else a
                for a in args)
        runner = (getattr(self.scheme, "module_runner", None)
                  if self.he_mode and self.scheme is not None else None)
        if runner is not None and self.is_leaf() and \
                any(hasattr(a, "cts") for a in args):
            out = runner(self, args)
        else:
            out = self.forward(*args)
        pb = self._modules.get("post_bootstrap")
        if pb is not None and self.he_mode:
            out = pb(out)
        hook = Module.output_hook
        if hook is not None and self.is_leaf():
            hook(self, out)
        return out

    def __repr__(self):
        inner = ", ".join(self._modules)
        return (f"{type(self).__name__}(level={self.level}"
                f"{', ' + inner if inner else ''})")


class Sequential(Module):
    """Container executing submodules in order."""

    def __init__(self, *mods):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ModuleList(Module):
    def __init__(self, mods=()):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def append(self, m):
        self.add_module(str(len(self._modules)), m)
        return self

    def forward(self, *x):
        raise RuntimeError("ModuleList is not callable")


def timer(func):
    """Debug tracer: per-layer wall time + clear-vs-FHE ranges when the
    config sets `debug: true`."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if not self.he_mode or self.scheme is None:
            return func(self, *args, **kwargs)
        debug = self.scheme.params.debug
        if debug:
            name = self.name or type(self).__name__
            print(f"\n{name}:")
            if hasattr(self, "input_min"):
                print(f"Clear input min/max: {self.input_min:.3f} / "
                      f"{self.input_max:.3f}")
            if args and hasattr(args[0], "min"):
                print(f"FHE input min/max: {args[0].min():.3f} / "
                      f"{args[0].max():.3f}")
            start = time.time()
        result = func(self, *args, **kwargs)
        if debug:
            omin = getattr(self, "output_min", getattr(self, "input_min", 0.0))
            omax = getattr(self, "output_max", getattr(self, "input_max", 0.0))
            print(f"Clear output min/max: {omin:.3f} / {omax:.3f}")
            if hasattr(result, "min"):
                print(f"FHE output min/max: {result.min():.3f} / "
                      f"{result.max():.3f}")
            print(f"done! [{time.time() - start:.3f} secs.]")
        return result

    return wrapper
