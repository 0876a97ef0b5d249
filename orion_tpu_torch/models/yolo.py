"""YOLOv1 detection head on a ResNet backbone.

Counterpart of `orion_tpu/models/yolo.py`.  The defaults are the full
model (512-channel head, SiLU(127), a 4096-unit fc, ResNet-34 backbone at
448x448 input); `width`, `act_degree` and `fc_dim` shrink the same graph
so fit and compile run at toy sizes.  The backbone's classification head
is stripped through `Identity`.
"""

import orion_tpu_torch.nn as on

from .resnet import ResNet34


class YOLOv1(on.Module):
    def __init__(self, backbone, num_bboxes=2, num_classes=20,
                 width=512, act_degree=127, fc_dim=4096):
        super().__init__()
        self.feature_size = 7
        self.num_bboxes = num_bboxes
        self.num_classes = num_classes
        self.width = width
        self.act_degree = act_degree
        self.fc_dim = fc_dim

        self.backbone = backbone
        self.conv_layers = self._make_conv_layers()
        self.fc_layers = self._make_fc_layers()

        # strip the backbone's classification head
        self.backbone.avgpool = on.Identity()
        self.backbone.flatten = on.Identity()
        self.backbone.linear = on.Identity()

    def _make_conv_layers(self):
        w, d = self.width, self.act_degree
        return on.Sequential(
            on.Conv2d(w, w, 3, padding=1),
            on.SiLU(degree=d),
            on.Conv2d(w, w, 3, stride=2, padding=1),
            on.SiLU(degree=d),
            on.Conv2d(w, w, 3, padding=1),
            on.SiLU(degree=d),
            on.Conv2d(w, w, 3, padding=1),
            on.SiLU(degree=d),
        )

    def _make_fc_layers(self):
        S, B, C = self.feature_size, self.num_bboxes, self.num_classes
        return on.Sequential(
            on.Flatten(),
            on.Linear(S * S * self.width, self.fc_dim),
            on.SiLU(degree=self.act_degree),
            on.Linear(self.fc_dim, S * S * (5 * B + C)),
        )

    def forward(self, x):
        x = self.backbone(x)
        x = self.conv_layers(x)
        x = self.fc_layers(x)
        return x


def YOLOv1_ResNet34():
    return YOLOv1(ResNet34(), num_bboxes=2, num_classes=20)
