"""SOF-VSR: video super-resolution through HR optical flow.

Counterpart of ``trainner_tpu/models/sofvsr.py`` (``channel_shuffle:34``,
``ResB:40``, ``CasResB:61``, ``_UpHead:73``, ``OFRnet:96``, ``SRnet:144``,
``SOFVSR:162``). A clip (b, n_frames, h, w, c) goes in; the flow of each
non-centre frame to the centre one is estimated at three levels (half
size, LR, HR) with the frame pairs folded into the batch; each frame is
warped by its HR flow sub-sampled at the scale² phase offsets, and the
draft cube (the centre frame and those warps, img_ch · (s²(n - 1) + 1)
channels) goes through the SR net: the ``rrdb`` tail is the port's
``RRDBNet`` with that many input channels, whose residual dense blocks run
the hand-written block kernels on the card (``ops/rdb5c.py``), or
``SRnet``.

Tensors are NHWC between the layers; each conv reads an NCHW view of them
(``channels_last`` memory, no copy) in the net's ``dtype`` and hands back
an NHWC view. The warps (``ops/warp.py::flow_warp_vsr``) and the flows'
upsamples (``ops/blocks.py::resize_torch``) add in a fixed order in their
backward, so a graphed step on the card equals its eager run bit for bit.
Module names are the flax ones (``OFR``, ``rnn1_conv``, ``resb{i}``,
``ps{i}``, ``SR``, ...), which ``flax_paths`` maps.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import Conv, conv_nhwc, depth_to_space, lecun_init, \
    named_flax_paths, resize_torch
from ..ops.warp import flow_warp_vsr
from .rrdb import RRDBNet


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NHWC channel shuffle: (groups, c / groups) -> (c / groups, groups)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4).reshape(
        b, h, w, c)


class _Net(nn.Module):
    """Runs its NCHW convs on NHWC tensors in the net's dtype."""

    dtype = torch.float32

    def _c(self, conv: Conv, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(conv, x, self.dtype)


class ResB(_Net):
    """Half the channels kept, the other half through 1x1, depthwise 3x3
    and 1x1 (no biases, LeakyReLU(0.1)), joined and shuffled."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        half = channels // 2
        self.half, self.dtype = half, dtype
        self.c1 = Conv(half, half, 1, use_bias=False)
        self.dw = Conv(half, half, 3, use_bias=False, groups=half)
        self.c2 = Conv(half, half, 1, use_bias=False)

    def forward(self, x):
        keep, body = x[..., :self.half], x[..., self.half:]
        h = _lrelu(self._c(self.c1, body))
        h = self._c(self.dw, h)
        h = _lrelu(self._c(self.c2, h))
        return channel_shuffle(torch.cat([keep, h], -1), 2)


class CasResB(nn.Module):
    def __init__(self, n_blocks: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = n_blocks
        for i in range(n_blocks):
            setattr(self, f"resb{i}", ResB(channels, dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"resb{i}")(x)
        return x


class _UpHead(_Net):
    """1x1 convs to 64 r² and pixel shuffles up to ``scale`` (LeakyReLU
    after each), then a 3x3 conv to ``out_ch``."""

    def __init__(self, in_ch: int, scale: int, out_ch: int,
                 final_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.steps = {4: [2, 2], 3: [3], 2: [2], 1: []}[scale]
        c = in_ch
        for i, r in enumerate(self.steps):
            setattr(self, f"ps{i}", Conv(c, 64 * r * r, 1, use_bias=False))
            c = 64
        if not self.steps:
            self.ps0 = Conv(c, 64, 1, use_bias=False)
        self.out = Conv(64, out_ch, 3, use_bias=final_bias)

    def forward(self, x):
        for i, r in enumerate(self.steps):
            x = _lrelu(depth_to_space(self._c(getattr(self, f"ps{i}"), x),
                                      r))
        if not self.steps:
            x = _lrelu(self._c(self.ps0, x))
        return self._c(self.out, x)


class OFRnet(_Net):
    """Coarse-to-fine flow of a frame pair (b, h, w, 2 img_ch) (moving,
    reference): L1 at half size, L2 at LR on the upsampled L1, L3 at HR
    on the upsampled L2."""

    def __init__(self, scale: int, channels: int, img_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.img_ch, self.dtype = scale, img_ch, dtype
        self.rnn1_conv = Conv(2 * img_ch + 2, channels, 3, use_bias=False)
        self.rnn1_body = CasResB(3, channels, dtype)
        self.rnn2 = Conv(channels, 2, 3, use_bias=False)
        self.sr_body = CasResB(3, channels, dtype)
        self.sr_head = _UpHead(channels, scale, 2, dtype=dtype)

    def _rnn1(self, x):
        return self.rnn1_body(_lrelu(self._c(self.rnn1_conv, x)))

    def forward(self, x):
        b, h, w, _ = x.shape
        ic = self.img_ch
        x_l1 = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        zeros = x.new_zeros((b, h // 2, w // 2, 2))
        flow_l1 = self._c(self.rnn2, self._rnn1(torch.cat([x_l1, zeros], -1)))
        flow_l1_up = resize_torch(flow_l1, size=(h, w)) * 2.0

        frame_a, frame_b = x[..., :ic], x[..., ic:]
        x_l2 = flow_warp_vsr(frame_a, flow_l1_up)
        flow_l2 = self._c(self.rnn2, self._rnn1(
            torch.cat([x_l2, frame_b, flow_l1_up], -1))) + flow_l1_up

        x_l3 = flow_warp_vsr(frame_a, flow_l2)
        feat = self._rnn1(torch.cat([x_l3, frame_b, flow_l2], -1))
        flow_l3 = self.sr_head(self.sr_body(feat)) + \
            resize_torch(flow_l2, scale=self.scale) * self.scale
        return flow_l1, flow_l2, flow_l3


class SRnet(_Net):
    """The draft cube's SR net: a 3x3 head, 8 ``ResB``, ``_UpHead`` with a
    biased last conv."""

    def __init__(self, in_nc: int, scale: int, channels: int, img_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.head = Conv(in_nc, channels, 3, use_bias=False)
        self.body = CasResB(8, channels, dtype)
        self.tail = _UpHead(channels, scale, img_ch, final_bias=True,
                            dtype=dtype)

    def forward(self, x):
        return self.tail(self.body(_lrelu(self._c(self.head, x))))


class SOFVSR(_Net):
    """x: (b, n_frames, h, w, img_ch) -> (flows_l1, flows_l2, flows_l3,
    SR centre frame), each flows list (n_frames - 1) of (b, h', w', 2);
    the SR frame in f32."""

    def __init__(self, scale: int = 4, n_frames: int = 3,
                 channels: int = 320, img_ch: int = 3,
                 sr_net: str = "sofvsr", sr_nf: int = 64, sr_nb: int = 23,
                 sr_gc: int = 32, sr_gaussian_noise: bool = True,
                 sr_plus: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.n_frames, self.dtype = scale, n_frames, dtype
        self.OFR = OFRnet(scale, channels, img_ch, dtype)
        in_nc = img_ch * (scale * scale * (n_frames - 1) + 1)
        if sr_net == "rrdb":
            self.SR = RRDBNet(in_nc=in_nc, out_nc=img_ch, nf=sr_nf,
                              nb=sr_nb, gc=sr_gc, upscale=scale,
                              gaussian_noise=sr_gaussian_noise, plus=sr_plus,
                              dtype=dtype)
        else:
            self.SR = SRnet(in_nc, scale, channels, img_ch, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init (LeCun normal, zero biases) for the flow
        net and ``SRnet``; the RRDB tail's own (Kaiming x 0.1)."""
        lecun_init(self.OFR, generator)
        if isinstance(self.SR, RRDBNet):
            self.SR.init_weights(generator)
        else:
            lecun_init(self.SR, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        from ..utils.torch_interop import g_flax_paths

        out = named_flax_paths(self.OFR, "OFR.", ("OFR",))
        if not isinstance(self.SR, RRDBNet):
            out.update(named_flax_paths(self.SR, "SR.", ("SR",)))
            return out
        for key, (coll, path) in g_flax_paths(self.SR).items():
            out[f"SR.{key}"] = (coll, ("SR",) + path, "conv"
                                if path[-1] == "kernel" else "vec")
        return out

    def forward(self, x):
        b, n = x.shape[:2]
        center = (n - 1) // 2
        others = [i for i in range(n) if i != center]
        pairs = torch.cat([torch.cat([x[:, i], x[:, center]], -1)
                           for i in others], 0)
        fl1, fl2, fl3 = self.OFR(pairs)
        flows_l1 = list(fl1.split(b))
        flows_l2 = list(fl2.split(b))
        flows_l3 = list(fl3.split(b))

        s = self.scale
        cube = [x[:, center]]
        for k, i in enumerate(others):
            hr_flow = flows_l3[k]
            for di in range(s):
                for dj in range(s):
                    sub = hr_flow[:, di::s, dj::s, :] / s
                    cube.append(flow_warp_vsr(x[:, i], sub))
        sr = self.SR(torch.cat(cube, -1))
        return flows_l1, flows_l2, flows_l3, sr
