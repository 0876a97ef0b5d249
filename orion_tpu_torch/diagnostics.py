"""Per-stage noise profiling of encrypted forwards.

Counterpart of `orion_tpu/diagnostics.py`.  At every leaf module boundary
the ciphertext is decrypted and compared elementwise with the cleartext
forward's value at the same stage, in the multiplexed slot layout
(`compiler/packing.mux_slots`).  The result is the noise-vs-depth curve
and the headroom against the end-to-end MAE bound.

The per-stage error is crypto noise plus polynomial-approximation error
for activation stages (sign composites, Chebyshev): the cleartext pass
evaluates the exact source functions, so it is the error that reaches the
network output.

Both passes observe the leaves through `Module.output_hook`, which fires
after a leaf's forward and its post_bootstrap.  Decryption copies each
ciphertext to the host and leaves the forward's tensors as they are, so
the profiled forward's output equals an unprofiled forward's bit for bit.
"""

from __future__ import annotations

import json
import time

import numpy as np

from .compiler.packing import mux_slots
from .nn.module import Module, to_numpy
from .nn.operations import Bootstrap


def _compare(clear: np.ndarray, decoded: np.ndarray, gap: int,
             fhe_shape) -> tuple[float, float]:
    """(max_err, rms_err) of decoded-vs-clear on the valid slot positions."""
    clear = np.asarray(clear, dtype=np.float64)
    decoded = np.asarray(decoded, dtype=np.float64)
    if clear.ndim == 4 and len(fhe_shape) == 4:
        errs = []
        grid = tuple(fhe_shape[1:])
        c, y, x = np.indices(clear.shape[1:])
        pos = mux_slots(c, y, x, int(gap), grid)
        keep = pos >= 0
        for b in range(clear.shape[0]):
            flat = decoded[b].reshape(-1)
            errs.append(flat[pos[keep]] - clear[b][keep])
        d = np.concatenate(errs)
    else:
        want = clear.reshape(-1)
        got = decoded.reshape(-1)[: want.size]
        d = got - want
    return float(np.max(np.abs(d))), float(np.sqrt(np.mean(d * d)))


def noise_profile(net, scheme, inp, input_level=None, ctxt=None
                  ) -> list[dict]:
    """Run clear + encrypted forwards of `net` on `inp`, decrypting at
    every leaf module.  Returns one record per stage, in execution order:

      {name, kind, level_in_plan, ct_level, scale_bits, max_err, rms_err,
       clear_absmax, seconds}

    `net` must be fitted and compiled; `inp` is one served batch.  The
    encrypted pass runs on `ctxt` when given (an encryption of `inp` at
    the input level), else on a fresh encryption of `inp`.
    """
    records: list[dict] = []
    clear_seq: list[tuple[str, np.ndarray]] = []

    # ---- pass 1: cleartext, recording every leaf output in order ----
    def clear_hook(module, out):
        clear_seq.append((module.name or type(module).__name__,
                          np.asarray(to_numpy(out), dtype=np.float64)))

    net.eval()
    Module.output_hook = clear_hook
    try:
        net(inp)
    finally:
        Module.output_hook = None

    # ---- pass 2: encrypted, decrypt-and-compare at each boundary ----
    host_by_name = {m.name: m for _, m in net.named_modules()
                    if getattr(m, "name", None)}
    state = {"idx": 0, "t": time.time()}

    def he_hook(module, out):
        name = module.name or type(module).__name__
        elapsed = time.time() - state["t"]
        if not hasattr(out, "decrypt"):
            state["t"] = time.time()
            return
        if isinstance(module, Bootstrap):
            # fired BEFORE its host module's own hook (post_bootstrap runs
            # inside the host's __call__): its clear reference is the next
            # unconsumed clear record, the host's output, which the
            # bootstrap must reproduce.  The layout is the host's too
            # (peeked, not consumed: the host's hook records itself)
            idx = state["idx"]
            if idx >= len(clear_seq):
                state["t"] = time.time()
                return
            cname, cval = clear_seq[idx]
            host = host_by_name.get(cname)
            gap = getattr(host, "output_gap", 1) or 1
            fshape = getattr(host, "fhe_output_shape", None) or \
                getattr(module, "fhe_input_shape", ())
            name = f"{cname}.bootstrap"
        else:
            idx = state["idx"]
            # align by name (robust to leaves that fire in one mode only)
            while idx < len(clear_seq) and clear_seq[idx][0] != name:
                idx += 1
            if idx >= len(clear_seq):
                state["t"] = time.time()
                return
            cval = clear_seq[idx][1]
            state["idx"] = idx + 1
            gap = getattr(module, "output_gap", 1) or 1
            fshape = getattr(module, "fhe_output_shape", None) or ()
            # shape-only modules (Flatten): the clear value is flattened,
            # but the ciphertext keeps the multiplexed input grid until
            # the next linear transform absorbs it: compare through the
            # input's layout
            ishape = getattr(module, "input_shape", None)
            if (cval.ndim != len(fshape) and ishape
                    and len(ishape) == len(fshape)
                    and int(np.prod(ishape)) == cval.size):
                cval = cval.reshape(ishape)
        decoded = np.asarray(out.decrypt().decode())
        max_err, rms = _compare(cval, decoded, gap, fshape)
        ct0 = out.cts[0]
        records.append(dict(
            name=name, kind=type(module).__name__,
            level_in_plan=getattr(module, "level", None),
            ct_level=int(ct0.level),
            scale_bits=float(np.log2(float(ct0.scale))),
            max_err=max_err, rms_err=rms,
            clear_absmax=float(np.max(np.abs(cval))),
            seconds=round(elapsed, 4)))
        state["t"] = time.time()

    net.he()
    if ctxt is None:
        ctxt = scheme.encrypt(scheme.encode(inp, input_level))
    Module.output_hook = he_hook
    state["t"] = time.time()
    try:
        net(ctxt)
    finally:
        Module.output_hook = None
    return records


def write_noise_report(records: list[dict], path: str, meta: dict | None
                       = None) -> dict:
    """Summarise + dump a noise profile to JSON; returns the summary."""
    worst = max(records, key=lambda r: r["max_err"]) if records else None
    boots = [r for r in records if r["kind"] == "Bootstrap"]
    out = {
        "meta": meta or {},
        "stages": len(records),
        "bootstraps": len(boots),
        "worst_stage": (dict(name=worst["name"], max_err=worst["max_err"])
                        if worst else None),
        "final_max_err": records[-1]["max_err"] if records else None,
        "final_rms_err": records[-1]["rms_err"] if records else None,
        "records": records,
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out
