"""AlexNet for CIFAR-10 with SiLU(127) activations.

Counterpart of `orion_tpu/models/alexnet.py`: five 3x3 conv blocks (Conv2d,
BatchNorm2d, SiLU(127)) with two AvgPool2d and an AdaptiveAvgPool2d((2, 2)),
then 1024-4096-4096-10.  SiLU(127) is a depth-7 Chebyshev polynomial, so on
configs/alexnet.yml the solver places bootstraps against polynomial depth;
after the first pool a feature tensor (192 x 16 x 16) spans 12
ciphertexts.
"""

import orion_tpu_torch.nn as on


class ConvBlock(on.Module):
    def __init__(self, Ci, Co, kernel_size, stride, padding):
        super().__init__()
        self.conv = on.Sequential(
            on.Conv2d(Ci, Co, kernel_size, stride, padding, bias=False),
            on.BatchNorm2d(Co),
            on.SiLU(degree=127))

    def forward(self, x):
        return self.conv(x)


class LinearBlock(on.Module):
    def __init__(self, ni, no):
        super().__init__()
        self.linear = on.Sequential(
            on.Linear(ni, no),
            on.BatchNorm1d(no),
            on.SiLU(degree=127))

    def forward(self, x):
        return self.linear(x)


class AlexNet(on.Module):
    cfg = [64, "M", 192, "M", 384, 256, 256, "A"]

    def __init__(self, num_classes=10):
        super().__init__()
        self.features = self._make_layers()
        self.flatten = on.Flatten()
        self.classifier = on.Sequential(
            LinearBlock(1024, 4096),
            LinearBlock(4096, 4096),
            on.Linear(4096, num_classes))

    def _make_layers(self):
        layers = []
        in_channels = 3
        for x in self.cfg:
            if x == "M":
                layers += [on.AvgPool2d(kernel_size=2, stride=2)]
            elif x == "A":
                layers += [on.AdaptiveAvgPool2d((2, 2))]
            else:
                layers += [ConvBlock(in_channels, x, kernel_size=3,
                                     stride=1, padding=1)]
                in_channels = x
        return on.Sequential(*layers)

    def forward(self, x):
        x = self.features(x)
        x = self.flatten(x)
        x = self.classifier(x)
        return x
