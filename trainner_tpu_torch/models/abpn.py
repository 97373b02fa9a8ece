"""ABPN_v5, the attention-based back-projection network (4x): counterpart
of ``trainner_tpu/models/abpn.py`` (``PReLU:26``, ``ConvB:33``,
``DeconvB:51``, ``Conv4x:66``, ``UpBlock:81``, ``DownBlock:99``,
``_spatial_attention:117``, ``SpaceAttention:131``, ``TimeAttention:151``,
``ABPN:171``).

Ten up / down back-projection stages (the 4x up a ``TorchDeconv`` k6 s4
p1, the 4x down a k6 s4 p1 conv, each with a scalar PReLU), a space
attention after the stem and a time attention after each down stage
(softmax over the LR positions in f32, cast back to the working type:
(h w)^2 per image, 1 GiB at a 128 x 128 LR in f32 for each of the 11
attention blocks), the dense concatenation of every stage's HR and LR
features, the bicubic residual (``bicubic_torch``) and the final LR
back-projection. Modules are NCHW in ``channels_last`` memory under the
flax names (``flax_paths``); ``forward`` takes and returns NHWC, the
output f32; the convs run in ``dtype`` with f32 parameters, the bicubic
residuals in the input's type, as the JAX module computes them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import (Conv, TorchDeconv, _Conv, bicubic_torch,
                          lecun_init, named_flax_paths)


class PReLU(nn.Module):
    """One learned slope ``alpha`` (0.25 at init) for every channel."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((), 0.25))

    def flax_leaves(self):
        return {"alpha": ("alpha", "vec")}

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _Conv4(_Conv):
    """The k6 s4 conv with one pixel of zero padding."""

    def __init__(self, in_nc: int, out_nc: int):
        super().__init__(in_nc, out_nc, 6, stride=4)

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv2d(
            x, w, b, stride=4, padding=1))


class ConvB(nn.Module):
    def __init__(self, in_nc: int, out_nc: int, k: int = 3):
        super().__init__()
        self.conv = Conv(in_nc, out_nc, k)
        self.act = PReLU()

    def forward(self, x):
        return self.act(self.conv(x))


class DeconvB(nn.Module):
    def __init__(self, in_nc: int, out_nc: int):
        super().__init__()
        self.deconv = TorchDeconv(in_nc, out_nc, 6, 4, 1, 0)
        self.act = PReLU()

    def forward(self, x):
        return self.act(self.deconv(x))


class Conv4x(nn.Module):
    def __init__(self, in_nc: int, out_nc: int):
        super().__init__()
        self.conv = _Conv4(in_nc, out_nc)
        self.act = PReLU()

    def forward(self, x):
        return self.act(self.conv(x))


class UpBlock(nn.Module):
    def __init__(self, in_nc: int, dim: int):
        super().__init__()
        self.conv1 = DeconvB(in_nc, dim)
        self.conv2 = Conv4x(dim, dim)
        self.local_weight1 = ConvB(in_nc, dim, 1)
        self.conv3 = DeconvB(dim, dim)
        self.local_weight2 = ConvB(dim, dim, 1)

    def forward(self, x):
        hr = self.conv1(x)
        residue = self.local_weight1(x) - self.conv2(hr)
        return self.local_weight2(hr) + self.conv3(residue)


class DownBlock(nn.Module):
    def __init__(self, in_nc: int, dim: int):
        super().__init__()
        self.conv1 = Conv4x(in_nc, dim)
        self.conv2 = DeconvB(dim, dim)
        self.local_weight1 = ConvB(in_nc, dim, 1)
        self.conv3 = Conv4x(dim, dim)
        self.local_weight2 = ConvB(dim, dim, 1)

    def forward(self, x):
        lr = self.conv1(x)
        residue = self.local_weight1(x) - self.conv2(lr)
        return self.local_weight2(lr) + self.conv3(residue)


def spatial_attention(k: torch.Tensor, q: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """softmax(K Q^T) over the positions (f32), applied to V; NCHW."""
    b, c, h, w = k.shape

    def flat(t):
        return t.permute(0, 2, 3, 1).reshape(b, h * w, -1)

    att = torch.softmax(torch.bmm(flat(k).float(),
                                  flat(q).float().transpose(1, 2)), dim=-1)
    out = torch.bmm(att.to(v.dtype), flat(v))
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class SpaceAttention(nn.Module):
    """K, Q, V of x by 1x1 convs, the attention, a 1x1 conv back to x's
    channels, plus x."""

    def __init__(self, in_nc: int, dim: int):
        super().__init__()
        self.K, self.Q, self.V = (Conv(in_nc, dim, 1) for _ in range(3))
        self.local_weight = Conv(dim, in_nc, 1)

    def forward(self, x):
        o = spatial_attention(self.K(x), self.Q(x), self.V(x))
        return x + self.local_weight(o)


class TimeAttention(nn.Module):
    """K and Q from x, V from y, a 1x1 conv back to y's channels, plus y."""

    def __init__(self, in_x: int, in_y: int, dim: int):
        super().__init__()
        self.K, self.Q = Conv(in_x, dim, 1), Conv(in_x, dim, 1)
        self.V = Conv(in_y, dim, 1)
        self.local_weight = Conv(dim, in_y, 1)

    def forward(self, x, y):
        o = spatial_attention(self.K(x), self.Q(x), self.V(y))
        return y + self.local_weight(o)


class ABPN(nn.Module):
    """ABPN_v5 at 4x."""

    def __init__(self, input_dim: int = 3, dim: int = 32, n_stages: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dim
        self.n_stages, self.dtype = n_stages, dtype
        self.feat1 = ConvB(input_dim, 2 * d)
        self.SA0 = SpaceAttention(2 * d, 2 * d)
        self.feat2 = ConvB(2 * d, d)
        for i in range(1, n_stages + 1):
            setattr(self, f"up{i}", UpBlock(d, d))
            if i >= 3:
                setattr(self, f"weight_up{i - 2}", ConvB(d, d, 1))
            if i == n_stages:
                break
            setattr(self, f"down{i}", DownBlock(d, d))
            if i >= 3:
                setattr(self, f"weight_down{i - 2}", ConvB(d, d, 1))
            setattr(self, f"SA{i}", TimeAttention(d, d, d))
        self.SR_conv1 = ConvB(n_stages * d, d, 1)
        self.SR_conv2 = ConvB(d, d)
        self.LR_conv1 = ConvB((n_stages - 1) * d, d, 1)
        self.LR_conv2 = UpBlock(d, d)
        self.SR_conv3 = Conv(d, input_dim, 3)
        self.final_feat1 = ConvB(input_dim, 2 * d)
        self.final_SA0 = SpaceAttention(2 * d, 2 * d)
        self.final_feat2 = Conv(2 * d, input_dim, 3)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init (LeCun normal, zero biases); slopes 0.25."""
        lecun_init(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, PReLU):
                    m.alpha.fill_(0.25)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def _nchw(self, x):
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    def forward(self, x):
        """NHWC LR -> NHWC 4x SR, f32."""
        bic = bicubic_torch(x, scale=4)
        feat = self.feat2(self.SA0(self.feat1(self._nchw(x))))
        ups, downs = [], []
        prev_down = feat
        for i in range(1, self.n_stages + 1):
            up = getattr(self, f"up{i}")(prev_down)
            if i >= 3:
                up = up + getattr(self, f"weight_up{i - 2}")(ups[i - 3])
            ups.append(up)
            if i == self.n_stages:
                break
            down = getattr(self, f"down{i}")(up)
            prev = prev_down if i < 3 else getattr(
                self, f"weight_down{i - 2}")(downs[i - 3])
            down = getattr(self, f"SA{i}")(prev, down)
            downs.append(down)
            prev_down = down
        hr_feat = self.SR_conv2(self.SR_conv1(torch.cat(ups, 1)))
        lr_feat = self.LR_conv2(self.LR_conv1(torch.cat(downs, 1)))
        sr_res = self.SR_conv3(hr_feat + lr_feat).permute(0, 2, 3, 1)
        sr = bic.to(sr_res.dtype) + sr_res
        lr_res = x - bicubic_torch(sr, scale=0.25).to(x.dtype)
        lr_res = self.final_feat2(self.final_SA0(self.final_feat1(
            self._nchw(lr_res)))).permute(0, 2, 3, 1)
        return (sr + bicubic_torch(lr_res, scale=4).to(sr.dtype)).float()
