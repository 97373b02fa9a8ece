"""PPON, the progressive perception-oriented SR generator: counterpart of
``trainner_tpu/models/ppon.py`` (``ResBlock32:35``, ``RRBlock32:60``,
``PPON:74``).

Three branches share a trunk: content (``fea_conv``, ``rb{i}``,
``lr_conv``, ``up_c*``, ``hr0_c``, ``hr1_c``), structure (``ssim0-1``,
``up_s*``, ``hr0_s``, ``hr1_s``, plus the content output) and perceptual
(``gan0-1``, ``up_p*``, ``hr0_p``, ``hr1_p``, plus the structure output).
``forward`` returns ``(out_c, out_s, out_p)``. Module names are the flax
module's, so ``utils/torch_interop.py::g_to_jax`` / ``g_from_jax`` move
weights both ways. Its convs (eight dilated 3x3 ones per ``ResBlock32``)
run on PyTorch's convolutions: the JAX package has no Pallas kernel on
this path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import Conv, UpconvBlock, _Conv


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResBlock32(nn.Module):
    """3x3 conv + lrelu, eight 3x3 convs at dilation 1..8 (nc -> nc / 2),
    their prefix sums joined (4 nc channels), lrelu, a 1x1 fuse back to
    nc, and a x0.2 residual."""

    def __init__(self, nc: int = 64):
        super().__init__()
        self.c1 = Conv(nc, nc)
        for r in range(1, 9):
            setattr(self, f"d{r}", Conv(nc, nc // 2, dilation=r))
        self.c2 = Conv(4 * nc, nc, 1)

    def forward(self, x):
        h = _lrelu(self.c1(x))
        acc = self.d1(h)
        partials = [acc]
        for r in range(2, 9):
            acc = acc + getattr(self, f"d{r}")(h)
            partials.append(acc)
        return x + self.c2(_lrelu(torch.cat(partials, dim=1))) * 0.2


class RRBlock32(nn.Module):
    """Three ``ResBlock32`` with a x0.2 outer residual."""

    def __init__(self, nc: int = 64):
        super().__init__()
        self.RB1, self.RB2, self.RB3 = (ResBlock32(nc) for _ in range(3))

    def forward(self, x):
        return self.RB3(self.RB2(self.RB1(x))) * 0.2 + x


class PPON(nn.Module):
    """NHWC in, the three branch outputs NHWC f32 out; the body in
    ``dtype`` with f32 parameters."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 24, upscale: int = 4,
                 act_type: str = "leakyrelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.nb = dtype, nb
        self.fea_conv = Conv(in_nc, nf)
        for i in range(nb):
            setattr(self, f"rb{i}", RRBlock32(nf))
        self.lr_conv = Conv(nf, nf)
        factors = [3] if upscale == 3 else [2] * int(math.log2(upscale))
        self.n_up = len(factors)
        for tag in ("c", "s", "p"):
            for i, r in enumerate(factors):
                setattr(self, f"up_{tag}{i}",
                        UpconvBlock(nf, nf, upscale=r, act_type=act_type))
            setattr(self, f"hr0_{tag}", Conv(nf, nf))
            setattr(self, f"hr1_{tag}", Conv(nf, out_nc))
        for i in range(2):
            setattr(self, f"ssim{i}", RRBlock32(nf))
            setattr(self, f"gan{i}", RRBlock32(nf))

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming-normal weights times 0.1 and zero biases for every conv
        (``kaiming_init(0.1)``)."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.init_weights(0.1, generator)

    def _branch(self, x, tag: str):
        for i in range(self.n_up):
            x = getattr(self, f"up_{tag}{i}")(x)
        x = _lrelu(getattr(self, f"hr0_{tag}")(x))
        return getattr(self, f"hr1_{tag}")(x)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        fea = self.fea_conv(x)
        t = fea
        for i in range(self.nb):
            t = getattr(self, f"rb{i}")(t)
        out_cfem = fea + self.lr_conv(t)
        out_c = self._branch(out_cfem, "c")
        out_sfem = self.ssim1(self.ssim0(out_cfem))
        out_s = self._branch(out_sfem, "s") + out_c
        out_pfem = self.gan1(self.gan0(out_sfem))
        out_p = self._branch(out_pfem, "p") + out_s
        return tuple(o.permute(0, 2, 3, 1).float().contiguous()
                     for o in (out_c, out_s, out_p))
