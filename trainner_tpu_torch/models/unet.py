"""The U-Net image-to-image generator (pix2pix's): counterpart of
``trainner_tpu/models/unet.py`` (``_norm:25``, ``_Down:36``, ``_Up:60``,
``UnetGenerator:87``).

``num_downs`` levels of ngf, 2ngf, 4ngf, then 8ngf channels. Down level i
is a LeakyReLU(0.2) (not at level 0), a 4x4 stride-2 conv and a norm (not
at the outermost level 0 nor at the innermost); up level i a ReLU, an up
(``deconv``: torch's ``ConvTranspose2d(k 4, s 2, p 1)``; else a nearest
2x upsample and a 3x3 conv) and a norm (not at level 0, whose up goes to
``output_nc``). A conv has a bias with the instance norm or where its
level has no norm (``:45``, ``:70``). The skip that reaches the decoder
is ``lrelu(x, 0.2)`` of the encoder's output, not the output itself: the
reference's in-place ``downrelu`` ran before its concatenation read it
(``:115-120``). Dropout 0.5 (``use_dropout``) follows the up of each
level of width 8 ngf other than the innermost and the outermost
(``:127-129``); each up but the outermost's is concatenated after its
skip; tanh at the end.

Takes and returns NHWC; the body runs in ``dtype``. Module names follow
the flax tree (``flax_paths``): ``down{i}`` and ``up{i}`` with ``Conv_0``
(or ``ConvTranspose_0``) and ``BatchNorm_0``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (Dropout, TorchDeconv, _Conv, conv_paths,
                          norm_paths)
from .resnet_g import _Net, conv, make_norm


class _Down(nn.Module):
    def __init__(self, in_nc: int, out_nc: int, norm_type: Optional[str],
                 use_act: bool, use_norm: bool):
        super().__init__()
        self.use_act = use_act
        use_bias = norm_type in ("IN", "instance") or not use_norm
        self.conv = _Conv(in_nc, out_nc, 4, use_bias, stride=2)
        self.norm = make_norm(norm_type, out_nc) if use_norm else None

    def forward(self, x):
        if self.use_act:
            x = F.leaky_relu(x, 0.2)
        x = conv(self.conv, x, 1)
        return self.norm(x) if self.norm is not None else x


class _Up(nn.Module):
    def __init__(self, in_nc: int, out_nc: int, norm_type: Optional[str],
                 upsample_mode: str, use_norm: bool):
        super().__init__()
        use_bias = norm_type in ("IN", "instance") or not use_norm
        self.up = TorchDeconv(in_nc, out_nc, 4, 2, 1, 0, use_bias) \
            if upsample_mode == "deconv" else _Conv(in_nc, out_nc, 3,
                                                    use_bias)
        self.norm = make_norm(norm_type, out_nc) if use_norm else None

    def forward(self, x):
        x = F.relu(x)
        if isinstance(self.up, TorchDeconv):
            x = self.up(x)
        else:
            x = conv(self.up, F.interpolate(x, scale_factor=2,
                                            mode="nearest"), 1)
        return self.norm(x) if self.norm is not None else x


class UnetGenerator(_Net):
    """The U-Net at the JAX module's defaults (8 levels, ngf 64, batch
    norm, deconv ups)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64,
                 norm_type: str = "batch", use_dropout: bool = False,
                 upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample_mode = upsample_mode
        feats = [ngf * m for m in [1, 2, 4] + [8] * (num_downs - 3)]
        n = len(feats)
        self.n = n
        for i, f in enumerate(feats):
            setattr(self, f"down{i}", _Down(
                input_nc if i == 0 else feats[i - 1], f, norm_type,
                use_act=i > 0, use_norm=0 < i < n - 1))
        for i in range(n):
            cin = feats[i] if i == n - 1 else 2 * feats[i]
            cout = output_nc if i == 0 else feats[i - 1]
            setattr(self, f"up{i}", _Up(cin, cout, norm_type, upsample_mode,
                                        use_norm=i > 0))
        self.dropouts = nn.ModuleDict({
            str(i): Dropout(0.5) for i in range(1, n - 1)
            if use_dropout and feats[i] == ngf * 8})

    def forward(self, x):
        x = self._nchw(x)
        skips = []
        for i in range(self.n):
            x = getattr(self, f"down{i}")(x)
            if i < self.n - 1:
                skips.append(F.leaky_relu(x, 0.2))
        for i in reversed(range(self.n)):
            x = getattr(self, f"up{i}")(x)
            if str(i) in self.dropouts:
                x = self.dropouts[str(i)](x)
            if i > 0:
                x = torch.cat([skips[i - 1], x], dim=1)
        return torch.tanh(x).permute(0, 2, 3, 1)

    def flax_paths(self) -> Dict[str, tuple]:
        out = {}
        for i in range(self.n):
            for side in ("down", "up"):
                m = getattr(self, f"{side}{i}")
                inner = m.conv if side == "down" else m.up
                name = "ConvTranspose_0" if isinstance(inner, TorchDeconv) \
                    else "Conv_0"
                key = f"{side}{i}.{'conv' if side == 'down' else 'up'}"
                out.update(conv_paths(key, inner, (f"{side}{i}", name)))
                if m.norm is not None:
                    out.update(norm_paths(f"{side}{i}.norm", m.norm,
                                          (f"{side}{i}", "BatchNorm_0")))
        return out
