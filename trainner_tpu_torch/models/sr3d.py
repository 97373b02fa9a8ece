"""SR3DNet: video SR with 3-D convs.

Counterpart of ``trainner_tpu/models/sr3d.py`` (``SR3DNet:26``). A clip
(b, n_frames, h, w, in_nc) goes through a dense residual stack of 3x3x3
convs (``conv_c`` one conv applied three times), then temporal-``VALID``
convs (``conv_c2`` as often as the frames need, then ``scalec``) collapse
the frame axis; the centre of what is left, plus the bicubic upscale of the
centre frame folded to the LR grid, is pixel-shuffled to HR. The convs run
on cuDNN in the net's ``dtype`` (NCDHW, ``channels_last_3d``); the bicubic
is torch's (a = -0.75, ``ops/blocks.py::resize_torch``), as the JAX
package's ``bicubic_torch``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import depth_to_space, lecun_init, named_flax_paths, \
    resize_torch, space_to_depth, _Conv


class _Conv3d(_Conv):
    """flax's 3x3x3 ``nn.Conv`` with a bias; ``temporal_valid`` pads only
    h and w (the JAX ``[(0, 0), (1, 1), (1, 1)]``)."""

    def __init__(self, in_nc: int, out_nc: int,
                 temporal_valid: bool = False):
        super().__init__(in_nc, out_nc, 3, True, dims=3)
        self.pad = (0, 1, 1) if temporal_valid else (1, 1, 1)

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv3d(
            x, w, b, padding=self.pad))


class SR3DNet(nn.Module):
    """x: (b, n_frames, h, w, in_nc) -> (b, h s, w s, out_nc) for the
    centre frame, f32. ``nb`` is read by neither package's net."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 3, scale: int = 4, n_frames: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = nf * in_nc
        self.scale, self.dtype = scale, dtype
        self.conv_input = _Conv3d(in_nc, feats)
        self.conv_c = _Conv3d(feats, feats)
        # applied (n_frames - 3) / 2 times: the JAX module has none at 3
        self.conv_c2 = _Conv3d(feats, feats, temporal_valid=True) \
            if n_frames > 3 else None
        self.scalec = _Conv3d(feats, out_nc * scale ** 2,
                              temporal_valid=True)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def forward(self, x):
        center = (x.shape[1] - 1) // 2
        lrelu = lambda v: F.leaky_relu(v, 0.2)  # noqa: E731
        v = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        conv1 = lrelu(self.conv_input(v))
        conv2 = lrelu(self.conv_c(conv1)) + conv1
        conv3 = lrelu(self.conv_c(conv2)) + conv1 + conv2
        conv4 = lrelu(self.conv_c(conv3)) + conv1 + conv2 + conv3
        h4 = conv4
        while h4.shape[2] > 3:
            h4 = lrelu(self.conv_c2(h4))
        out = lrelu(self.scalec(h4))
        out = out[:, :, out.shape[2] // 2].permute(0, 2, 3, 1)
        bic = space_to_depth(resize_torch(x[:, center].float(),
                                          scale=self.scale, mode="bicubic"),
                             self.scale)
        return depth_to_space(out + bic.to(out.dtype), self.scale).float()
