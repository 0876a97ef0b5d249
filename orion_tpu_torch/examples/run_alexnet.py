"""AlexNet/CIFAR-10 encrypted inference (orion_tpu's
examples/run_alexnet.py).  By default fit and compile only; --fhe also
runs the encrypted forward.

    python -m orion_tpu_torch.examples.run_alexnet \
        [--config configs/alexnet.yml] [--fhe] [--cpu]
"""

import sys

from orion_tpu_torch import models
from orion_tpu_torch.examples.common import parse, run
from orion_tpu_torch.utils import get_cifar_datasets


def main(argv=None):
    args = parse(argv, "alexnet.yml", fhe_flag=True)
    return run(args, models.AlexNet, get_cifar_datasets,
               steady_input="fresh")


if __name__ == "__main__":
    main(sys.argv[1:])
