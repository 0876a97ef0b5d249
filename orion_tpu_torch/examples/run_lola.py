"""Encrypted LoLA inference end to end (orion_tpu's examples/run_lola.py).

    python -m orion_tpu_torch.examples.run_lola \
        [--config configs/lola.yml] [--cpu]
"""

import sys

from orion_tpu_torch import models
from orion_tpu_torch.examples.common import parse, run
from orion_tpu_torch.utils import get_mnist_datasets


def main(argv=None):
    args = parse(argv, "lola.yml", fhe_flag=False)
    return run(args, models.LoLA, get_mnist_datasets,
               steady_input="same")


if __name__ == "__main__":
    main(sys.argv[1:])
