"""EDVR: video restoration with deformable alignment.

Counterpart of ``trainner_tpu/models/edvr.py`` (``ResidualBlockNoBN:42``,
``PCDAlignment:58``, ``TSAFusion:111``, ``PredeblurModule:166``,
``EDVR:203``): per-frame features (the frames folded into the batch), a
three-level pyramid, PCD alignment of every frame to the centre one by
DCNv2 (``ops/deform_conv.py``, the reference pyramid repeated per frame),
TSA fusion (temporal attention by correlation with the centre frame's
embedding, a spatial attention pyramid) or a 1x1 fusion, reconstruction
blocks, pixel-shuffle (or nearest ``upconv``) upsampling and the bilinear
upscale of the centre frame added. NHWC between the layers, each conv on
an NCHW view (cuDNN) in the net's ``dtype``; module names are the flax
ones, which ``flax_paths`` maps.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import Conv, bilinear_torch, conv_nhwc as _c, \
    depth_to_space, interpolate, kaiming_init_, named_flax_paths, \
    nearest_up
from ..ops.deform_conv import DCNv2Pack


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return bilinear_torch(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    """3x3 pool, stride 2, padding 1 (an average over 9, padding
    included), NHWC."""
    v = x.permute(0, 3, 1, 2)
    v = F.max_pool2d(v, 3, 2, 1) if kind == "max" else \
        F.avg_pool2d(v, 3, 2, 1, count_include_pad=True)
    return v.permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv plus the identity (Kaiming x 0.1 at init)."""

    def __init__(self, nf: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(nf, nf, 3)
        self.conv2 = Conv(nf, nf, 3)

    def forward(self, x):
        return x + _c(self.conv2, F.relu(_c(self.conv1, x))) * self.res_scale


class PCDAlignment(nn.Module):
    """Pyramid, cascading, deformable alignment of the neighbour pyramid
    ``nbr`` to ``ref`` (lists L1..L3, (b, h_l, w_l, nf) each)."""

    def __init__(self, nf: int = 64, deformable_groups: int = 8):
        super().__init__()
        for i in (3, 2, 1):
            lv = f"l{i}"
            setattr(self, f"offset_conv1_{lv}", Conv(2 * nf, nf, 3))
            setattr(self, f"offset_conv2_{lv}",
                    Conv(nf if i == 3 else 2 * nf, nf, 3))
            if i < 3:
                setattr(self, f"offset_conv3_{lv}", Conv(nf, nf, 3))
                setattr(self, f"feat_conv_{lv}", Conv(2 * nf, nf, 3))
            setattr(self, f"dcn_{lv}",
                    DCNv2Pack(nf, nf, nf, 3, deformable_groups))
        self.cas_offset_conv1 = Conv(2 * nf, nf, 3)
        self.cas_offset_conv2 = Conv(nf, nf, 3)
        self.cas_dcn = DCNv2Pack(nf, nf, nf, 3, deformable_groups)

    def forward(self, nbr, ref):
        up_offset = up_feat = feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            g = lambda name: getattr(self, f"{name}_{lv}")  # noqa: E731
            offset = _lrelu(_c(g("offset_conv1"),
                               torch.cat([nbr[i - 1], ref[i - 1]], -1)))
            if i == 3:
                offset = _lrelu(_c(g("offset_conv2"), offset))
            else:
                offset = _lrelu(_c(g("offset_conv2"),
                                   torch.cat([offset, up_offset], -1)))
                offset = _lrelu(_c(g("offset_conv3"), offset))
            feat = g("dcn")(nbr[i - 1], offset)
            if i < 3:
                feat = _c(g("feat_conv"), torch.cat([feat, up_feat], -1))
            if i > 1:
                feat = _lrelu(feat)
                up_offset = _up2(offset) * 2.0
                up_feat = _up2(feat)
        offset = _lrelu(_c(self.cas_offset_conv1,
                           torch.cat([feat, ref[0]], -1)))
        offset = _lrelu(_c(self.cas_offset_conv2, offset))
        return _lrelu(self.cas_dcn(feat, offset))


class TSAFusion(nn.Module):
    """Temporal and spatial attention fusion: (b, t, h, w, nf) -> (b, h,
    w, nf)."""

    def __init__(self, nf: int = 64, num_frame: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        self.center = center_frame_idx
        k3 = ("temporal_attn1", "temporal_attn2", "spatial_attn_l2",
              "spatial_attn_l3", "spatial_attn3", "spatial_attn5")
        ins = {"feat_fusion": num_frame * nf, "spatial_attn1":
               num_frame * nf, "spatial_attn2": 2 * nf,
               "spatial_attn_l2": 2 * nf}
        for name in k3 + ("feat_fusion", "spatial_attn1", "spatial_attn2",
                          "spatial_attn_l1", "spatial_attn4",
                          "spatial_attn_add1", "spatial_attn_add2"):
            setattr(self, name, Conv(ins.get(name, nf), nf,
                                     3 if name in k3 else 1))

    def forward(self, aligned):
        b, t, h, w, c = aligned.shape
        emb_ref = _c(self.temporal_attn1, aligned[:, self.center])
        emb = _c(self.temporal_attn2, aligned.reshape(b * t, h, w, c)
                 ).reshape(b, t, h, w, -1)
        corr = (emb * emb_ref[:, None]).sum(-1)
        prob = torch.sigmoid(corr)[..., None]
        weighted = (aligned * prob.to(aligned.dtype)).permute(
            0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        feat = _lrelu(_c(self.feat_fusion, weighted))
        attn = _lrelu(_c(self.spatial_attn1, weighted))
        attn = _lrelu(_c(self.spatial_attn2, torch.cat(
            [_pool(attn, "max"), _pool(attn, "avg")], -1)))
        lvl = _lrelu(_c(self.spatial_attn_l1, attn))
        lvl = _lrelu(_c(self.spatial_attn_l2, torch.cat(
            [_pool(lvl, "max"), _pool(lvl, "avg")], -1)))
        lvl = _up2(_lrelu(_c(self.spatial_attn_l3, lvl)))
        attn = _lrelu(_c(self.spatial_attn3, attn)) + lvl
        attn = _up2(_lrelu(_c(self.spatial_attn4, attn)))
        attn = _c(self.spatial_attn5, attn)
        attn_add = _c(self.spatial_attn_add2,
                      _lrelu(_c(self.spatial_attn_add1, attn)))
        return feat * torch.sigmoid(attn) * 2.0 + attn_add


class PredeblurModule(nn.Module):
    """The pyramid pre-deblur head."""

    def __init__(self, in_nc: int = 3, nf: int = 64, hr_in: bool = False):
        super().__init__()
        self.hr_in = hr_in
        self.conv_first = Conv(in_nc, nf, 3)
        names = (["stride_conv_hr1", "stride_conv_hr2"] if hr_in else []) \
            + ["stride_conv_l2", "stride_conv_l3"]
        for name in names:
            setattr(self, name, Conv(nf, nf, 3, stride=2))
        for name in ["resblock_l3", "resblock_l2_1", "resblock_l2_2"] + \
                [f"resblock_l1_{i}" for i in range(5)]:
            setattr(self, name, ResidualBlockNoBN(nf))

    def forward(self, x):
        l1 = _lrelu(_c(self.conv_first, x))
        if self.hr_in:
            l1 = _lrelu(_c(self.stride_conv_hr1, l1))
            l1 = _lrelu(_c(self.stride_conv_hr2, l1))
        l2 = _lrelu(_c(self.stride_conv_l2, l1))
        l3 = _lrelu(_c(self.stride_conv_l3, l2))
        l3 = _up2(self.resblock_l3(l3))
        l2 = self.resblock_l2_1(l2) + l3
        l2 = _up2(self.resblock_l2_2(l2))
        for i in range(2):
            l1 = getattr(self, f"resblock_l1_{i}")(l1)
        l1 = l1 + l2
        for i in range(2, 5):
            l1 = getattr(self, f"resblock_l1_{i}")(l1)
        return l1


class EDVR(nn.Module):
    """(b, t, h, w, c) clip -> (b, h s, w s, out) centre frame, f32."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_feat: int = 64, num_frame: int = 5,
                 deformable_groups: int = 8, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10,
                 center_frame_idx: Optional[int] = None, hr_in: bool = False,
                 with_predeblur: bool = False, with_tsa: bool = True,
                 upscale: int = 4, upsample_mode: str = "pixelshuffle",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = num_feat
        self.nf, self.dtype, self.upscale = nf, dtype, upscale
        self.hr_in, self.with_predeblur = hr_in, with_predeblur
        self.with_tsa, self.upsample_mode = with_tsa, upsample_mode
        self.n_extract, self.n_recon = num_extract_block, \
            num_reconstruct_block
        self.center = center_frame_idx if center_frame_idx is not None \
            else num_frame // 2
        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch, nf, hr_in)
            self.conv_1x1 = Conv(nf, nf, 1)
        else:
            self.conv_first = Conv(num_in_ch, nf, 3)
        for i in range(num_extract_block):
            setattr(self, f"extract{i}", ResidualBlockNoBN(nf))
        self.conv_l2_1 = Conv(nf, nf, 3, stride=2)
        self.conv_l2_2 = Conv(nf, nf, 3)
        self.conv_l3_1 = Conv(nf, nf, 3, stride=2)
        self.conv_l3_2 = Conv(nf, nf, 3)
        self.pcd_align = PCDAlignment(nf, deformable_groups)
        self.fusion = TSAFusion(nf, num_frame, self.center) if with_tsa \
            else Conv(num_frame * nf, nf, 1)
        for i in range(num_reconstruct_block):
            setattr(self, f"recon{i}", ResidualBlockNoBN(nf))
        self.n_up = int(math.log2(upscale))
        c = nf
        for i in range(self.n_up):
            f = nf if i < self.n_up - 1 else 64
            setattr(self, f"upconv{i + 1}",
                    Conv(c, f if upsample_mode == "upconv" else f * 4, 3))
            c = f
        self.conv_hr = Conv(c, 64, 3)
        self.conv_last = Conv(64, num_out_ch, 3)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init as the JAX module draws it: LeCun normal, Kaiming x
        0.1 in the residual blocks, zero offset convs, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, DCNv2Pack)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
            for m in self.modules():
                if isinstance(m, ResidualBlockNoBN):
                    kaiming_init_(m.conv1.weight, 0.1, generator)
                    kaiming_init_(m.conv2.weight, 0.1, generator)
                elif isinstance(m, DCNv2Pack):
                    m.conv_offset.weight.zero_()

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def forward(self, x):
        b, t, h, w, c = x.shape
        nf = self.nf
        x_center = x[:, self.center]
        flat = x.reshape(b * t, h, w, c).to(self.dtype)
        if self.with_predeblur:
            l1 = _c(self.conv_1x1, self.predeblur(flat))
            if self.hr_in:
                h, w = h // self.upscale, w // self.upscale
        else:
            l1 = _lrelu(_c(self.conv_first, flat))
        for i in range(self.n_extract):
            l1 = getattr(self, f"extract{i}")(l1)
        l2 = _lrelu(_c(self.conv_l2_1, l1))
        l2 = _lrelu(_c(self.conv_l2_2, l2))
        l3 = _lrelu(_c(self.conv_l3_1, l2))
        l3 = _lrelu(_c(self.conv_l3_2, l3))
        pyr = [l1.reshape(b, t, h, w, nf),
               l2.reshape(b, t, h // 2, w // 2, nf),
               l3.reshape(b, t, h // 4, w // 4, nf)]
        ref = [p[:, self.center, None].expand(-1, t, -1, -1, -1).reshape(
            b * t, *p.shape[2:]) for p in pyr]
        nbr = [p.reshape(b * t, *p.shape[2:]) for p in pyr]
        aligned = self.pcd_align(nbr, ref).reshape(b, t, h, w, nf)
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = _c(self.fusion, aligned.permute(0, 2, 3, 1, 4).reshape(
                b, h, w, t * nf))
        out = feat
        for i in range(self.n_recon):
            out = getattr(self, f"recon{i}")(out)
        for i in range(self.n_up):
            conv = getattr(self, f"upconv{i + 1}")
            if self.upsample_mode == "upconv":
                out = _lrelu(_c(conv, nearest_up(out, 2)))
            else:
                out = _lrelu(depth_to_space(_c(conv, out), 2))
        out = _lrelu(_c(self.conv_hr, out))
        out = _c(self.conv_last, out)
        base = x_center if self.hr_in else interpolate(
            x_center, scale=self.upscale, mode="bilinear")
        return (out + base.to(out.dtype)).float()
