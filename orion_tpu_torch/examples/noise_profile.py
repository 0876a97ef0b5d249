"""Per-stage noise budget of an encrypted model forward (orion_tpu's
tools/noise_profile.py).

Runs fit -> compile -> noise_profile (decrypt-and-compare at every leaf
module, in the multiplexed slot layout: orion_tpu_torch/diagnostics.py)
and writes NOISE_<model>.json with the per-stage curve and the headroom
against the MAE < 0.005 bound.

    python -m orion_tpu_torch.examples.noise_profile --model resnet20 \
        [--config configs/resnet.yml] [--out NOISE_resnet20.json] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from orion_tpu_torch.examples.common import CONFIGS

MODELS = {
    "mlp": ("mlp.yml", "MLP", "mnist"),
    "lola": ("lola.yml", "LoLA", "mnist"),
    "lenet": ("lenet.yml", "LeNet", "mnist"),
    "resnet20": ("resnet.yml", "ResNet20", "cifar"),
    "vgg11": ("vgg.yml", "VGG11", "cifar"),
    "alexnet": ("alexnet.yml", "AlexNet", "cifar"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, choices=sorted(MODELS))
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the host")
    args = ap.parse_args(argv)

    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.diagnostics import noise_profile, write_noise_report
    from orion_tpu_torch.utils import get_cifar_datasets, get_mnist_datasets

    cfg_name, cls_name, dataset = MODELS[args.model]
    config = args.config or str(CONFIGS / cfg_name)
    scheme = orion.init_scheme(config, device="cpu" if args.cpu else None)
    loader_fn = (get_cifar_datasets if dataset == "cifar"
                 else get_mnist_datasets)
    trainloader, testloader = loader_fn(batch_size=1)
    net = getattr(models, cls_name)()

    inp, _ = next(iter(testloader))
    net.eval()
    orion.fit(net, trainloader)
    t0 = time.time()
    input_level = orion.compile(net)
    print(f"compile done in {time.time() - t0:.1f}s; "
          f"input_level={input_level}", flush=True)

    t0 = time.time()
    records = noise_profile(net, scheme, np.asarray(inp), input_level)
    print(f"forward+profile {time.time() - t0:.1f}s", flush=True)
    out_path = args.out or f"NOISE_{args.model}.json"
    rep = write_noise_report(records, out_path, meta={
        "model": args.model, "config": config,
        "device": str(scheme.ctx.device), "bound": 0.005,
        "note": ("per-stage error = crypto noise + polynomial-"
                 "approximation error vs the exact cleartext forward, "
                 "compared elementwise in the multiplexed slot layout"),
    })
    print(f"stages={rep['stages']} bootstraps={rep['bootstraps']} "
          f"final_max_err={rep['final_max_err']:.3e} "
          f"worst={rep['worst_stage']}", flush=True)
    for r in records:
        print(f"  {r['name']:32s} {r['kind']:14s} L{r['ct_level']:>2} "
              f"max={r['max_err']:.2e} rms={r['rms_err']:.2e} "
              f"[{r['seconds']:.2f}s]", flush=True)
    return rep


if __name__ == "__main__":
    main(sys.argv[1:])
