"""Device-buffer residency of the encrypted ResNet-20 forward on the card
(orion_tpu's examples/resnet_hbm_report.py).

Compiles the full pipeline on `cuda` with the config's io_mode (stream in
configs/resnet.yml) and prints, per leaf module, the buffer bytes its
forward reads (runtime/buffers.hbm_report), the key and key-pack totals,
and beside them what the card holds: torch.cuda.memory_allocated() after
compile and after one encrypted forward, with the bytes the forward
promoted and uploaded under the residency budget.

    python -m orion_tpu_torch.examples.hbm_report \
        [--config configs/resnet.yml]
"""

import argparse
import sys
import time

import torch

from orion_tpu_torch.examples.common import CONFIGS


def fmt(b):
    return f"{b / 2**30:.2f} GiB" if b > 2**28 else f"{b / 2**20:.1f} MiB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(CONFIGS / "resnet.yml"))
    args = ap.parse_args(argv)

    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.runtime.buffers import (buffer_bytes,
                                                 collect_swappables,
                                                 hbm_report)
    from orion_tpu_torch.utils import get_cifar_datasets

    scheme = orion.init_scheme(args.config, device="cuda")
    trainloader, testloader = get_cifar_datasets(batch_size=1)
    net = models.ResNet20()
    net.eval()
    orion.fit(net, trainloader)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    level = orion.compile(net)
    torch.cuda.synchronize()
    print(f"compile: {time.time() - t0:.1f}s; io_mode "
          f"{scheme.params.io_mode}; device memory allocated "
          f"{fmt(torch.cuda.memory_allocated())}, compile peak "
          f"{fmt(torch.cuda.max_memory_allocated())}")

    rep = hbm_report(scheme, net)
    print(f"\nTOTAL unique buffer bytes: {fmt(rep['total'])}")
    for name, b in sorted(rep["per_module"].items(),
                          key=lambda kv: -kv[1])[:20]:
        print(f"  {name:45s} {fmt(b)}")
    worst = max((buffer_bytes(collect_swappables(scheme, m)), n)
                for n, m in net.named_modules() if m.is_leaf())
    print(f"\nworst single-module buffers: {worst[1]} = {fmt(worst[0])}")

    keys = scheme.keys
    kb = sum(int(g.data.nbytes) + int(g.shoup.nbytes)
             for g in keys.galois_keys.values())
    rb = int(keys.relin_key.data.nbytes) + int(keys.relin_key.shoup.nbytes)
    packs = scheme.evaluator._key_packs.values()
    pb = sum(int(p.ksk.nbytes) + (0 if p.ksk_shoup is None
                                  else int(p.ksk_shoup.nbytes))
             for p in packs)
    print(f"original galois keys: {fmt(kb)} ({len(keys.galois_keys)})")
    print(f"relin key: {fmt(rb)}")
    print(f"key packs: {fmt(pb)} ({len(scheme.evaluator._key_packs)})")

    ct = orion.encrypt(orion.encode(next(iter(testloader))[0], level))
    net.he()
    net(ct)
    torch.cuda.synchronize()
    runner = scheme.module_runner
    print(f"\nafter one encrypted forward: device memory allocated "
          f"{fmt(torch.cuda.memory_allocated())}; hbm_report total "
          f"{fmt(rep['total'])}")
    if runner is not None:
        print(f"streamed at compile {fmt(scheme.spilled_bytes)}; promoted "
              f"{fmt(runner.resident_bytes)} (budget "
              f"{fmt(runner.budget)}); uploaded in the forward "
              f"{fmt(runner.uploaded_bytes)}")
    return rep


if __name__ == "__main__":
    main(sys.argv[1:])
