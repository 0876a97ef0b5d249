"""ResNet-20/CIFAR-10 encrypted inference (orion_tpu's
examples/run_resnet.py).  By default fit and compile only (packing,
level assignment, bootstrap placement and the bootstrappers); --fhe also
runs the encrypted forward.

    python -m orion_tpu_torch.examples.run_resnet \
        [--config configs/resnet.yml] [--fhe] [--cpu]
"""

import sys

from orion_tpu_torch import models
from orion_tpu_torch.examples.common import parse, run
from orion_tpu_torch.utils import get_cifar_datasets


def main(argv=None):
    args = parse(argv, "resnet.yml", fhe_flag=True)
    return run(args, models.ResNet20, get_cifar_datasets,
               steady_input="fresh")


if __name__ == "__main__":
    main(sys.argv[1:])
