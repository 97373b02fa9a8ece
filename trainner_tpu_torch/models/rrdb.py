"""ESRGAN generator: residual dense blocks, RRDB and RRDBNet.

Counterpart of ``trainner_tpu/models/rrdb.py`` (``ResidualDenseBlock5C:449``,
``RRDB:532``, ``RRDBNet:589``) with the unrolled trunk. Module names follow
the reference ``.pth`` "new" layout (``conv_first``,
``RRDB_trunk.{i}.RDB{j}.conv{k}``, ``trunk_conv``, ``upconv{n}``,
``HRconv``, ``conv_last``), so a reference state_dict loads with
``load_state_dict``.

Every residual dense block runs the hand-written kernels of ``ops.rdb5c``
(their plain PyTorch versions on the CPU): ``rdb5c_forward`` alone when no
gradient is asked for, ``RDB5CFunction`` (forward with residuals, kernel
backward) under autograd. The unfused five-conv chain (``_unfused_forward``)
is kept only as a test oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.blocks import (ConvBlock, GaussianNoise, PixelShuffleBlock,
                          UpconvBlock, _Conv, finalact)
from ..ops import rdb5c
from ..ops.rdb5c import pack_block


class ResidualDenseBlock5C(nn.Module):
    """Five-conv residual dense block, LeakyReLU(0.2), out = 0.2*c5 + x.

    The packed stage weights are built once per (dtype, device) and again
    only after the conv weights change (a load_state_dict, an optimizer
    step), tracked by the parameters' version counters. A graph's replay
    changes the weights without a version change, so a caller that runs
    graphs drops the cache (``drop_packed``) before it runs the block
    eagerly again. They are packed at
    the kernels' widths (nf and gc padded with zeros to multiples of 32,
    ``ops.rdb5c.pack_block``), so a narrow block pads only its activations
    per call."""

    def __init__(self, nf: int = 64, gc: int = 32,
                 gaussian_noise: bool = False):
        super().__init__()
        self.nf, self.gc = nf, gc
        for k in range(1, 5):
            setattr(self, f"conv{k}", ConvBlock(nf + (k - 1) * gc, gc, 3,
                                                act_type="leakyrelu"))
        self.conv5 = ConvBlock(nf + 4 * gc, nf, 3, act_type=None)
        self.noise = GaussianNoise(0.1) if gaussian_noise else None
        self._packed = {}

    def convs(self):
        return [getattr(self, f"conv{k}") for k in range(1, 6)]

    def packed(self, dtype: torch.dtype):
        """(packed weights in ``dtype``, f32 biases) for the kernel, at its
        widths. While a CUDA graph is being captured the block packs every
        time, into tensors the graph owns, and leaves the cache alone: the
        host's version check runs once, at capture, and a replay must read
        the weights as the optimizer left them."""
        params = [p for c in self.convs() for p in (c.weight, c.bias)]
        if params[0].is_cuda and torch.cuda.is_current_stream_capturing():
            with torch.no_grad():
                return pack_block([c.weight for c in self.convs()],
                                  [c.bias for c in self.convs()],
                                  self.nf, self.gc, dtype)
        # tensors made under inference_mode cannot be saved for backward,
        # so the two modes keep separate entries
        key = (dtype, params[0].device, torch.is_inference_mode_enabled())
        stamp = tuple(p._version for p in params) + tuple(
            p.data_ptr() for p in params)
        hit = self._packed.get(key)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                ws, bs = pack_block([c.weight for c in self.convs()],
                                    [c.bias for c in self.convs()],
                                    self.nf, self.gc, dtype)
            hit = (stamp, ws, bs)
            self._packed[key] = hit
        return hit[1], hit[2]

    def forward(self, x):
        """x: NCHW in channels_last memory."""
        nhwc = x.permute(0, 2, 3, 1)
        if torch.is_grad_enabled():
            params = [p for c in self.convs() for p in (c.weight, c.bias)]
            out = rdb5c.RDB5CFunction.apply(nhwc, self.packed, *params)
        else:
            ws, bs = self.packed(x.dtype)
            out = rdb5c.rdb5c_forward(nhwc, ws, bs)
        out = out.permute(0, 3, 1, 2)
        return out if self.noise is None else self.noise(out)

    def _unfused_forward(self, x):
        """The plain five-conv chain (test oracle)."""
        x1 = self.conv1(x)
        x2 = self.conv2(torch.cat([x, x1], 1))
        x3 = self.conv3(torch.cat([x, x1, x2], 1))
        x4 = self.conv4(torch.cat([x, x1, x2, x3], 1))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


def drop_packed(net: nn.Module) -> None:
    """Empties the packed-weight cache of every block of ``net``."""
    for m in net.modules():
        if isinstance(m, ResidualDenseBlock5C):
            m._packed.clear()


class RRDB(nn.Module):
    """nr residual dense blocks with a 0.2-scaled skip."""

    def __init__(self, nf: int = 64, gc: int = 32, nr: int = 3,
                 gaussian_noise: bool = False):
        super().__init__()
        self.nr = nr
        for i in range(nr):
            setattr(self, f"RDB{i + 1}",
                    ResidualDenseBlock5C(nf, gc, gaussian_noise))

    def forward(self, x):
        out = x
        for i in range(self.nr):
            out = getattr(self, f"RDB{i + 1}")(out)
        return out * 0.2 + x


class RRDBNet(nn.Module):
    """Original ESRGAN generator: conv_first -> nb RRDB -> trunk_conv,
    + skip -> 2x upsamplers -> HRconv -> conv_last -> finalact.

    ``forward`` takes and returns NHWC, like the JAX module, and runs in
    ``dtype`` (parameters stay f32); the output is f32."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, nr: int = 3, gc: int = 32, upscale: int = 4,
                 act_type: str = "leakyrelu",
                 upsample_mode: str = "upconv",
                 final_act: Optional[str] = None,
                 gaussian_noise: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsample_mode not in ("upconv", "pixelshuffle"):
            raise NotImplementedError(
                f"upsample mode [{upsample_mode}] not found")
        self.dtype = dtype
        self.conv_first = ConvBlock(in_nc, nf, 3, act_type=None)
        self.RRDB_trunk = nn.ModuleList(
            [RRDB(nf, gc, nr, gaussian_noise) for _ in range(nb)])
        self.trunk_conv = ConvBlock(nf, nf, 3, act_type=None)
        up = UpconvBlock if upsample_mode == "upconv" else PixelShuffleBlock
        factors = [3] if upscale == 3 else [2] * int(math.log2(upscale))
        self.n_up = len(factors)
        for i, r in enumerate(factors):
            setattr(self, f"upconv{i + 1}",
                    up(nf, nf, upscale=r, act_type=act_type))
        self.HRconv = ConvBlock(nf, nf, 3, act_type=act_type)
        self.conv_last = ConvBlock(nf, out_nc, 3, act_type=None)
        self.final_act = finalact(final_act)

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming-normal weights times 0.1 and zero biases, as every conv
        of the JAX module draws (``kaiming_init(0.1)``)."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.init_weights(0.1, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        fea = self.conv_first(x)
        trunk = fea
        for block in self.RRDB_trunk:
            trunk = block(trunk)
        fea = fea + self.trunk_conv(trunk)
        for i in range(self.n_up):
            fea = getattr(self, f"upconv{i + 1}")(fea)
        out = self.conv_last(self.HRconv(fea))
        out = self.final_act(out)
        return out.permute(0, 2, 3, 1).float().contiguous()
