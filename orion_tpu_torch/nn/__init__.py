from .module import Module, Sequential, ModuleList
from .linear import Conv2d, Linear, LinearTransform
from .activation import (Activation, Quad, Chebyshev, ELU, Hardshrink, GELU,
                         SiLU, Sigmoid, SELU, Softplus, Mish, ReLU, _Sign)
from .normalization import BatchNormNd, BatchNorm1d, BatchNorm2d
from .pooling import AvgPool2d, AdaptiveAvgPool2d
from .operations import Add, Mult, Bootstrap
from .reshape import Flatten, Identity

__all__ = [
    "Module", "Sequential", "ModuleList",
    "Linear", "LinearTransform", "Conv2d",
    "Activation", "Quad", "Chebyshev", "ELU", "Hardshrink", "GELU", "SiLU",
    "Sigmoid", "SELU", "Softplus", "Mish", "ReLU",
    "BatchNormNd", "BatchNorm1d", "BatchNorm2d",
    "AvgPool2d", "AdaptiveAvgPool2d",
    "Add", "Mult", "Bootstrap", "Flatten", "Identity",
]
