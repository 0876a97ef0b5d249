#!/usr/bin/env python3
"""Count the port's kernel launches that torch.profiler fails to record.

    python3 tools/profile_probe.py [--trials 20]

chip_smoke.py holds every profile it reads against the launches the
wrappers counted.  This script repeats such profiles on one GPU (a
warm-up call, then the recorded one) and prints for each kind of call how
many profiles lost records and where in the call the lost launches were
(their index among the port's device kernels, in launch order).  The
calls: the LeNet forward of configs/lenet.yml, one bootstrap of
configs/resnet.yml, and one `mod_drop_rescale` call.  Each
is profiled `--trials` times with no pause around the recorded call (as
chip_smoke.py took its profiles until it padded them), then as often with
the host idle for `--pad-ms` on both sides of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# device kernels of each wrapper's launch, in order
GRIDS = {"ntt_fwd": ["ntt_fwd_cluster"], "ntt_inv": ["ntt_inv_cluster"],
         "ks_decompose": ["ntt_inv_zq", "hoist_digits", "fbc_ntt_digits"],
         "ks_finish": ["ks_inner_intt", "hoist_digits", "moddown_rows"],
         "drop_intt": ["drop_intt_rows"], "drop_ntt": ["drop_lift_ntt"],
         "rescale_ntt": ["rescale_lift_ntt"]}


def record_launches():
    """Patch Kernel.launch to log each launch's device kernels in order."""
    from orion_tpu_torch.kernels import _launch

    log = []
    launch = _launch.Kernel.launch

    def logged(self, device, *args, grids=1, **kw):
        launch(self, device, *args, grids=grids, **kw)
        names = GRIDS[self.name]
        if grids < len(names):
            # ks_decompose skips its inverse NTT, ks_finish_raw its ModDown
            names = names[-1:] if self.name == "ks_decompose" else names[:1]
        log.extend(names)

    _launch.Kernel.launch = logged
    return log


def profile(fn, log, pad_ms):
    """One profiled call of fn after a warm-up call, as chip_smoke.py's
    profile_device takes it (pad_ms = 0) or with the host idle pad_ms on
    both sides of the recorded call.  Returns the port's device kernels
    launched and recorded, in order."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    with tprofile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1,
                                    repeat=1)) as prof:
        for step in range(2):
            if step and pad_ms:
                time.sleep(pad_ms / 1e3)
            log.clear()
            fn()
            torch.cuda.synchronize()
            launched = list(log)
            if step and pad_ms:
                time.sleep(pad_ms / 1e3)
            prof.step()
    events = sorted(
        (e.time_range.start, o) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        for o in cs.OUR_KERNELS if o in e.name)
    return launched, [o for _, o in events]


def lost_at(launched, recorded):
    """Indices (in launch order) of the launches the profile lacks."""
    lost, j = [], 0
    for i, name in enumerate(launched):
        if j < len(recorded) and recorded[j] == name:
            j += 1
        else:
            lost.append((i, name))
    return lost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_probe: no CUDA device", file=sys.stderr)
        return 1
    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.kernels import _build, rescale
    from orion_tpu_torch.runtime.scheme import Scheme
    from orion_tpu_torch.utils import get_mnist_datasets

    _build.build_all()
    log = record_launches()
    cfgs = {t: yaml.safe_load(open(p)) for t, p in cs.CONFIGS.items()}

    orion.init_scheme(cfgs["lenet"], device="cuda")
    train, test = get_mnist_datasets(batch_size=1)
    net = models.LeNet()
    inp, _ = next(iter(test))
    net.eval()
    orion.fit(net, train)
    level = orion.compile(net)
    ct = orion.encrypt(orion.encode(inp, level))
    net.he()

    from orion_tpu_torch.crypto.keyswitch import dev_level

    dl = dev_level(cs.make_context(cfgs["lenet"]), 5)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 1 << 62, (2, dl.t.p.shape[0], dl.ring_n),
                      generator=gen, device="cuda") % dl.t.p[:, None]

    out = {}

    def trials(name, fn, n):
        for pad in (0.0, args.pad_ms):
            rec = out.setdefault(f"{name} pad {pad:g} ms", {
                "profiles": 0, "lossy": 0, "lost": []})
            for _ in range(n):
                launched, recorded = profile(fn, log, pad)
                lost = lost_at(launched, recorded)
                rec["profiles"] += 1
                rec["launched"] = len(launched)
                if lost or len(recorded) != len(launched):
                    rec["lossy"] += 1
                    rec["lost"].append({"n_recorded": len(recorded),
                                        "at": lost[:5]})
            print(f"PROBE {json.dumps({f'{name} pad {pad:g} ms': rec})}",
                  flush=True)

    trials("lenet_forward", lambda: net(ct), args.trials)
    trials("mod_drop_rescale", lambda: rescale.mod_drop_rescale(x, dl),
           args.trials)
    orion.delete_scheme()
    sch = Scheme().init_scheme(cfgs["resnet"], device="cuda")
    btp = sch.bootstrapper.generate_bootstrapper(sch.ctx.slots)
    msg = np.random.default_rng(17).uniform(-1, 1, sch.ctx.slots)
    bct = sch.encryptor.encrypt(
        sch.encoder.encode(msg, level=sch.params.base_level)).cts[0]
    trials("bootstrap", lambda: btp.bootstrap(bct), max(2, args.trials // 3))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
