import numpy as np
import torch

from .lenet import LeNet
from .lola import LoLA
from .mlp import MLP

__all__ = ["LeNet", "LoLA", "MLP", "load_jax_params"]


def load_jax_params(net: torch.nn.Module, params: dict) -> None:
    """Load weights and statistics taken from an orion_tpu network.

    `params` maps module paths ("fc1.weight", "conv1.bias",
    "bn1.running_mean", ...) to numpy arrays, as read off the orion_tpu
    net's parameters and BatchNorm statistics.  Linear weights are
    (out, in) and Conv2d weights OIHW in both packages, so every array
    loads as it is (`load_state_dict` raises on a shape that differs).
    Every parameter and buffer of `net` must be present: the two packages
    draw initial weights from one module-level generator, so weights only
    agree when they are carried across explicitly.
    """
    state = net.state_dict()
    missing = sorted(set(state) - set(params))
    extra = sorted(set(params) - set(state))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    net.load_state_dict({
        k: torch.as_tensor(np.asarray(v)).to(state[k].dtype)
        for k, v in params.items()})
