# The benchmark's frozen copy of fsvid2vid_tpu_torch/models/vgg.py, its imports
# pointed at this package: it imports nothing of the port.
"""VGG19 feature extractor of the perceptual loss (port of
fsvid2vid_tpu/models/vgg.py, reference models/networks/vgg.py), NCHW.

torchvision's `vgg19.features` layer sequence with taps after layers
(1, 6, 11, 20, 29) = relu1_1 ... relu5_1; parameter names are torchvision's
(`features.{idx}.weight`), so its state dict loads directly.  Images stay in
the generator's [-1, 1] range.  The pretrained weights are not bundled:
without them the extractor runs with seeded random weights, as the JAX
package does.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

_C, _R, _P = "conv", "relu", "pool"
VGG19_LAYERS = [
    (_C, 64), _R, (_C, 64), _R, _P,
    (_C, 128), _R, (_C, 128), _R, _P,
    (_C, 256), _R, (_C, 256), _R, (_C, 256), _R, (_C, 256), _R, _P,
    (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, _P,
    (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, (_C, 512), _R, _P,
]
VGG_LOSS_TAPS = (1, 6, 11, 20, 29)
VGG_LOSS_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


class Vgg19Features(nn.Module):
    """Runs vgg19.features up to the last tap and returns the activations
    after the layers whose indices are in `taps`."""

    def __init__(self, taps: Sequence[int] = VGG_LOSS_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        layers, cin = [], 3
        for layer in VGG19_LAYERS[:max(self.taps) + 1]:
            if layer == _R:
                layers.append(nn.ReLU())
            elif layer == _P:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.Conv2d(cin, layer[1], 3, padding=1))
                cin = layer[1]
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        results = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.taps:
                results.append(x)
        return results
