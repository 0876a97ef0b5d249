import numpy as np
import torch

from .alexnet import AlexNet
from .lenet import LeNet
from .lola import LoLA
from .mlp import MLP
from .resnet import (ResNet, ResNet18, ResNet20, ResNet32, ResNet34,
                     ResNet44, ResNet50, ResNet56, ResNet101, ResNet110,
                     ResNet152, ResNet1202)
from .vgg import VGG, VGG11, VGG13, VGG16, VGG19
from .yolo import YOLOv1, YOLOv1_ResNet34

__all__ = ["AlexNet", "LeNet", "LoLA", "MLP", "ResNet", "ResNet18",
           "ResNet20", "ResNet32", "ResNet34", "ResNet44", "ResNet50",
           "ResNet56", "ResNet101", "ResNet110", "ResNet152", "ResNet1202",
           "VGG", "VGG11", "VGG13", "VGG16", "VGG19", "YOLOv1",
           "YOLOv1_ResNet34", "load_jax_params"]


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
