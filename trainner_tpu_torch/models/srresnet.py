"""SRResNet / SRGAN generator: counterpart of
``trainner_tpu/models/srresnet.py`` (``ResNetBlock:23``, ``SRResNet:49``).

Module names are the JAX module's (``fea_conv``, ``res{i}.conv0`` /
``conv1``, ``LR_conv``, ``up{i}``, ``HR_conv0``, ``HR_conv1``); the
reference ``.pth`` of a norm-free SRResNet loads through
``utils/torch_interop.py::srresnet_to_params``. Its convs run on PyTorch's
convolutions: the JAX package has no Pallas kernel on this path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.blocks import (ConvBlock, PixelShuffleBlock, UpconvBlock, _Conv,
                          finalact)


class ResNetBlock(nn.Module):
    """Two 3x3 ConvBlocks with EDSR's residual scaling: x + res_scale *
    conv1(conv0(x)); in CNA and CNAC the second has no activation, in
    CNAC no norm either."""

    def __init__(self, nf: int, norm_type: Optional[str] = None,
                 act_type: str = "relu", mode: str = "CNA",
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv0 = ConvBlock(nf, nf, 3, act_type=act_type,
                               norm_type=norm_type, mode=mode)
        self.conv1 = ConvBlock(
            nf, nf, 3, act_type=None if mode in ("CNA", "CNAC") else act_type,
            norm_type=None if mode == "CNAC" else norm_type, mode=mode)

    def forward(self, x):
        return x + self.conv1(self.conv0(x)) * self.res_scale


class SRResNet(nn.Module):
    """fea_conv -> [nb ResNetBlocks -> LR_conv] + skip -> upsamplers
    (pixel shuffle or nearest upconv; 2x each, or one 3x) -> HR_conv0 ->
    HR_conv1 -> finalact. NHWC in and out, the body in ``dtype``, the
    output f32."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 16, upscale: int = 4,
                 norm_type: Optional[str] = "batch", act_type: str = "relu",
                 mode: str = "NAC", res_scale: float = 1.0,
                 upsample_mode: str = "pixelshuffle",
                 final_act: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsample_mode == "upconv":
            up = UpconvBlock
        elif upsample_mode == "pixelshuffle":
            up = PixelShuffleBlock
        else:
            raise NotImplementedError(
                f"upsample mode [{upsample_mode}] not found")
        self.dtype, self.nb = dtype, nb
        self.fea_conv = ConvBlock(in_nc, nf, 3, act_type=None)
        for i in range(nb):
            setattr(self, f"res{i}", ResNetBlock(nf, norm_type, act_type,
                                                 mode, res_scale))
        self.LR_conv = ConvBlock(nf, nf, 3, act_type=None,
                                 norm_type=norm_type, mode=mode)
        factors = [3] if upscale == 3 else [2] * int(math.log2(upscale))
        self.n_up = len(factors)
        for i, r in enumerate(factors):
            setattr(self, f"up{i}", up(nf, nf, upscale=r, act_type=act_type))
        self.HR_conv0 = ConvBlock(nf, nf, 3, act_type=act_type)
        self.HR_conv1 = ConvBlock(nf, out_nc, 3, act_type=None)
        self.final_act = finalact(final_act)

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming-normal weights times 0.1 and zero biases for every conv
        (``kaiming_init(0.1)``); norms and PReLU slopes keep their
        initial values."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.init_weights(0.1, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        fea = self.fea_conv(x)
        trunk = fea
        for i in range(self.nb):
            trunk = getattr(self, f"res{i}")(trunk)
        fea = fea + self.LR_conv(trunk)
        for i in range(self.n_up):
            fea = getattr(self, f"up{i}")(fea)
        out = self.final_act(self.HR_conv1(self.HR_conv0(fea)))
        return out.permute(0, 2, 3, 1).float().contiguous()
