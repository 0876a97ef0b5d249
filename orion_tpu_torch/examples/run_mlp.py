"""Encrypted MLP inference end to end (orion_tpu's examples/run_mlp.py).

    python -m orion_tpu_torch.examples.run_mlp \
        [--config configs/mlp.yml] [--cpu]
"""

import sys

from orion_tpu_torch import models
from orion_tpu_torch.examples.common import parse, run
from orion_tpu_torch.utils import get_mnist_datasets


def main(argv=None):
    args = parse(argv, "mlp.yml", fhe_flag=False)
    return run(args, models.MLP, get_mnist_datasets,
               steady_input="same")


if __name__ == "__main__":
    main(sys.argv[1:])
