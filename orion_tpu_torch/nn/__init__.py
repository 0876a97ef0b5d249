from .module import Module
from .linear import Conv2d, Linear, LinearTransform
from .activation import Quad
from .normalization import BatchNormNd, BatchNorm1d, BatchNorm2d
from .reshape import Flatten

__all__ = [
    "Module", "Linear", "LinearTransform", "Conv2d",
    "Quad", "BatchNormNd", "BatchNorm1d", "BatchNorm2d", "Flatten",
]
