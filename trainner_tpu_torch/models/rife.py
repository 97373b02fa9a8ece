"""RIFE: intermediate frame interpolation.

Counterpart of ``trainner_tpu/models/rife.py`` (``PReLU:30``, ``_Conv:37``,
``ResBlock:59``, ``IFBlock:91``, ``IFNet:115``, ``ContextNet:141``,
``FusionNet:162``, ``RIFE:198``): IFNet's three blocks estimate the flow
coarse to fine (1/4, 1/2 and 1 of the half-size pair, batch norm and PReLU,
SE-gated residual blocks), ContextNet's pyramid features are warped by the
flow, FusionNet's U-Net (flax's ``ConvTranspose``, SAME padding) refines
the merge of the two warped frames. Warps are ``ops/warp.py::
flow_warp_pix`` with border padding. In train mode the net returns
(pred, mask, merged, w0, w1), else pred. NHWC between the layers, convs
on NCHW views in the net's ``dtype``; module names are flax's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import BatchNorm, Conv, conv_nhwc, depth_to_space, \
    interpolate, lecun_init, named_flax_paths
from ..ops.warp import flow_warp_pix


def _warp(x, flow):
    return flow_warp_pix(x, flow, padding_mode="border")


class _PReLU(nn.Module):
    """One slope, ``alpha`` (0.25 at init)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def flax_leaves(self) -> dict:
        return {"alpha": ("alpha", "vec")}

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _Dtype(nn.Module):
    dtype = torch.float32

    def _c(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(conv, x, self.dtype)


class _ConvU(_Dtype):
    """3x3 conv (a bias in ``rife`` mode; batch norm after it in
    ``ifnet`` mode), then PReLU unless ``act`` is off."""

    def __init__(self, in_nc: int, features: int, stride: int = 1,
                 mode: str = "rife", act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_nc, features, 3, use_bias=mode == "rife",
                         stride=stride)
        self.bn = BatchNorm(features) if mode == "ifnet" else None
        self.act = _PReLU() if act else None

    def forward(self, x):
        v = self.conv(x.to(self.dtype).contiguous().permute(0, 3, 1, 2))
        if self.bn is not None:
            v = self.bn(v)
        v = v.permute(0, 2, 3, 1)
        return self.act(v) if self.act is not None else v


class ResBlock(_Dtype):
    """Residual block with SE-style channel gating."""

    def __init__(self, in_nc: int, out_planes: int, stride: int = 1,
                 mode: str = "rife", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = None if in_nc == out_planes and stride == 1 else \
            Conv(in_nc, out_planes, 3, use_bias=False, stride=stride)
        self.conv1 = _ConvU(in_nc, out_planes, stride, mode, dtype=dtype)
        self.conv2 = _ConvU(out_planes, out_planes, 1, mode, act=False,
                            dtype=dtype)
        self.fc1 = Conv(out_planes, 16, 1, use_bias=False)
        self.relu1 = _PReLU()
        self.fc2 = Conv(16, out_planes, 1, use_bias=False)
        self.relu2 = _PReLU()

    def forward(self, x):
        y = x if self.conv0 is None else self._c(self.conv0, x)
        h = self.conv2(self.conv1(x))
        w = h.mean((1, 2), keepdim=True)
        w = torch.sigmoid(self._c(self.fc2, self.relu1(self._c(self.fc1, w))))
        return self.relu2(h * w + y)


class IFBlock(_Dtype):
    def __init__(self, in_nc: int, scale: int = 1, c: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        self.conv0 = _ConvU(in_nc, c, 2, "ifnet", dtype=dtype)
        for i in range(6):
            setattr(self, f"res{i}", ResBlock(c, c, 1, "ifnet", dtype))
        self.conv1 = Conv(c, 8, 3)

    def forward(self, x):
        if self.scale != 1:
            x = interpolate(x, scale=1.0 / self.scale, mode="bilinear")
        x = self.conv0(x)
        for i in range(6):
            x = getattr(self, f"res{i}")(x)
        flow = depth_to_space(self._c(self.conv1, x), 2)
        if self.scale != 1:
            flow = interpolate(flow, scale=self.scale, mode="bilinear")
        return flow


class IFNet(nn.Module):
    """Coarse-to-fine flow of the pair (b, h, w, 6) at half size."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block0 = IFBlock(6, 4, 192, dtype)
        self.block1 = IFBlock(8, 2, 128, dtype)
        self.block2 = IFBlock(8, 1, 64, dtype)

    def forward(self, x):
        x = interpolate(x, scale=0.5, mode="bilinear")
        img0, img1 = x[..., :3], x[..., 3:]
        f0 = self.block0(x)
        w0, w1 = _warp(img0, f0[..., :2]), _warp(img1, -f0[..., :2])
        f1 = self.block1(torch.cat([w0, w1, f0], -1))
        f01 = f0 + f1
        w0, w1 = _warp(img0, f01[..., :2]), _warp(img1, -f01[..., :2])
        f2 = self.block2(torch.cat([w0, w1, f01], -1))
        flow = f0 + f1 + f2
        return flow, [f0, f01, flow]


class ContextNet(nn.Module):
    """Four stride-2 residual blocks, each level's features warped by the
    flow halved as often."""

    def __init__(self, c: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = [3, c, 2 * c, 4 * c, 8 * c]
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    ResBlock(chans[i], chans[i + 1], 2, "rife", dtype))

    def forward(self, x, flow):
        feats, f = [], flow
        for i in range(4):
            x = getattr(self, f"conv{i + 1}")(x)
            if i > 0:
                f = interpolate(f, scale=0.5, mode="bilinear") * 0.5
            feats.append(_warp(x, f[..., :2]))
        return feats


class _Deconv(Conv):
    """flax's ``ConvTranspose`` (4 x 4, stride 2, SAME): the kernel
    correlates the zero-dilated input padded by 2 on each side, unflipped.
    ``weight`` holds the flax kernel as a conv's OIHW; torch's
    ``conv_transpose2d`` flips its kernel, so it is given the flipped
    one."""

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv_transpose2d(
            x, w.transpose(0, 1).flip(2, 3), b, stride=2, padding=1))


class FusionNet(_Dtype):
    def __init__(self, c: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.down0 = ResBlock(8, 2 * c, 2, "rife", dtype)
        self.down1 = ResBlock(4 * c, 4 * c, 2, "rife", dtype)
        self.down2 = ResBlock(8 * c, 8 * c, 2, "rife", dtype)
        self.down3 = ResBlock(16 * c, 16 * c, 2, "rife", dtype)
        for i, (cin, cout) in enumerate(((32 * c, 8 * c), (16 * c, 4 * c),
                                         (8 * c, 2 * c), (4 * c, c))):
            setattr(self, f"up{i}", _Deconv(cin, cout, 4))
            setattr(self, f"up{i}_act", _PReLU())
        self.conv = Conv(c, 4, 3)

    def _up(self, i, v):
        return getattr(self, f"up{i}_act")(self._c(getattr(self, f"up{i}"),
                                                   v))

    def forward(self, img0, img1, flow, c0, c1):
        w0, w1 = _warp(img0, flow[..., :2]), _warp(img1, -flow[..., :2])
        s0 = self.down0(torch.cat([w0, w1, flow], -1))
        s1 = self.down1(torch.cat([s0, c0[0], c1[0]], -1))
        s2 = self.down2(torch.cat([s1, c0[1], c1[1]], -1))
        s3 = self.down3(torch.cat([s2, c0[2], c1[2]], -1))
        x = self._up(0, torch.cat([s3, c0[3], c1[3]], -1))
        x = self._up(1, torch.cat([x, s2], -1))
        x = self._up(2, torch.cat([x, s1], -1))
        x = self._up(3, torch.cat([x, s0], -1))
        return self._c(self.conv, x), w0, w1


class RIFE(nn.Module):
    """imgs (b, h, w, 6) = (img0, img1), h and w multiples of 32 -> the
    middle frame (b, h, w, 3), f32; in train mode (pred, mask, merged, w0,
    w1)."""

    def __init__(self, c: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.flownet = IFNet(dtype)
        self.contextnet = ContextNet(c, dtype)
        self.fusionnet = FusionNet(c, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def forward(self, imgs):
        flow, _ = self.flownet(imgs)
        img0, img1 = imgs[..., :3], imgs[..., 3:]
        c0 = self.contextnet(img0, flow)
        c1 = self.contextnet(img1, -flow)
        flow_up = interpolate(flow, scale=2, mode="bilinear") * 2.0
        refine, w0, w1 = self.fusionnet(img0, img1, flow_up, c0, c1)
        res = torch.sigmoid(refine[..., :3]) * 2.0 - 1.0
        mask = torch.sigmoid(refine[..., 3:4])
        merged = w0 * mask + w1 * (1.0 - mask)
        pred = torch.clamp(merged + res, 0.0, 1.0)
        if self.training:
            return pred, mask, merged, w0, w1
        return pred.float()
