"""Data + metric utilities.

Counterpart of `orion_tpu/utils.py`.  Without network access the MNIST
loader falls back to deterministic synthetic data with the right shapes
when no cached dataset is available, and the CIFAR loader always gives
the same synthetic images as orion_tpu's: statistics fitting and the
FHE-vs-cleartext oracle only need representative ranges, not real labels.
"""

from __future__ import annotations

import numpy as np


def mae(a, b) -> float:
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    return float(np.mean(np.abs(a - b)))


class ArrayLoader:
    """Minimal DataLoader stand-in: iterates (x, y) numpy batches."""

    def __init__(self, x, y, batch_size):
        self.x = x
        self.y = y
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.x), self.batch_size):
            yield (self.x[i:i + self.batch_size],
                   self.y[i:i + self.batch_size])

    def __len__(self):
        return (len(self.x) + self.batch_size - 1) // self.batch_size


def _synthetic_images(n, shape, seed, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n,) + shape).astype(np.float32)
    y = rng.integers(0, classes, size=n)
    return x, y


def _try_torchvision_mnist(data_dir):
    try:
        from torchvision import datasets, transforms  # type: ignore
    except ImportError:
        return None
    t = transforms.ToTensor()
    try:
        train = datasets.MNIST(data_dir, train=True, download=False,
                               transform=t)
        test = datasets.MNIST(data_dir, train=False, download=False,
                              transform=t)
    except RuntimeError:  # dataset not on disk
        return None
    xtr = train.data.numpy()[:, None].astype(np.float32) / 255.0
    ytr = train.targets.numpy()
    xte = test.data.numpy()[:, None].astype(np.float32) / 255.0
    yte = test.targets.numpy()
    return (xtr, ytr), (xte, yte)


def get_mnist_datasets(data_dir="./data", batch_size=1, n_synth=512):
    cached = _try_torchvision_mnist(data_dir)
    if cached is not None:
        (xtr, ytr), (xte, yte) = cached
    else:
        xtr, ytr = _synthetic_images(n_synth, (1, 28, 28), seed=0)
        xte, yte = _synthetic_images(64, (1, 28, 28), seed=1)
    return (ArrayLoader(xtr, ytr, batch_size),
            ArrayLoader(xte, yte, batch_size))


def get_cifar_datasets(data_dir="./data", batch_size=1, n_synth=512):
    xtr, ytr = _synthetic_images(n_synth, (3, 32, 32), seed=0)
    xte, yte = _synthetic_images(64, (3, 32, 32), seed=1)
    return (ArrayLoader(xtr, ytr, batch_size),
            ArrayLoader(xte, yte, batch_size))
