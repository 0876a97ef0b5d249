"""VGG nets for CIFAR-10.

Counterpart of `orion_tpu/models/vgg.py`: 3x3 convs with BatchNorm2d and
the minimax ReLU (15, 15, 27), AvgPool2d between stages, then Linear
512 -> 10.  On configs/vgg.yml VGG-11's first stage (64 x 32 x 32) spans
16 ciphertexts and its last (512 x 2 x 2) half the slots, so its
bootstraps there run the 2048-slot circuit.
"""

import orion_tpu_torch.nn as on

cfg = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512,
              512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(on.Module):
    def __init__(self, vgg_name):
        super().__init__()
        self.features = self._make_layers(cfg[vgg_name])
        self.classifier = on.Linear(512, 10)
        self.flatten = on.Flatten()

    def forward(self, x):
        out = self.features(x)
        out = self.flatten(out)
        out = self.classifier(out)
        return out

    def _make_layers(self, layer_cfg):
        layers = []
        in_channels = 3
        for x in layer_cfg:
            if x == "M":
                layers += [on.AvgPool2d(kernel_size=2, stride=2)]
            else:
                layers += [
                    on.Conv2d(in_channels, x, kernel_size=3, padding=1),
                    on.BatchNorm2d(x),
                    on.ReLU(degrees=[15, 15, 27]),
                ]
                in_channels = x
        layers += [on.AvgPool2d(kernel_size=1, stride=1)]
        return on.Sequential(*layers)


def VGG11():
    return VGG("VGG11")


def VGG13():
    return VGG("VGG13")


def VGG16():
    return VGG("VGG16")


def VGG19():
    return VGG("VGG19")
