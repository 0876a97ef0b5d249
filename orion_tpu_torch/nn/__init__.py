from .module import Module
from .linear import Linear, LinearTransform
from .activation import Quad
from .normalization import BatchNormNd, BatchNorm1d
from .reshape import Flatten

__all__ = [
    "Module", "Linear", "LinearTransform",
    "Quad", "BatchNormNd", "BatchNorm1d", "Flatten",
]
