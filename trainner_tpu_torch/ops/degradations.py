"""Batched on-device degradation ops on NHWC tensors in [0, 1].

Counterpart of ``trainner_tpu/ops/degradations.py`` for what the bsrgan
and resrgan blind-SR configurations reach: ``_grid:33``, ``_random_support_mask:39``,
``gaussian_kernels:57``, ``apply_kernels:192``, ``gaussian_noise:236``, the
DCT tables and ``jpeg_compress:451``, ``resize_batch:676``,
``random_resize:695``, ``down_up:711``, ``nearest_aligned_downscale:726``,
``_mosaic_masks:738``, ``_malvar_demosaic:760`` and ``camera_noise:811``.

Every op works on the whole batch with per-sample parameters and is split
in two: ``draw_*(gen, b, ...)`` draws the parameters from an explicit
``torch.Generator`` (on the generator's device), and the op itself is a
deterministic function of its input and those parameters, so a test can
feed it another framework's draws. Nothing here records gradients: the
producer runs under ``torch.no_grad()``.

``apply_kernels`` has one result for every k, the cross-correlation with
reflect padding. On a CUDA tensor it launches the hand-written kernel
``csrc/blur_per_sample.cu``; on a CPU tensor it runs the plain version.

Also ``sinc_kernels:90``, ``poisson_noise:271`` and, for the cv2-style
resize codes 0-6, ``jax.image.resize`` (``ops/imresize.py::jax_resize``).
The other ops of the JAX module (motion and box kernels, speckle and
salt-and-pepper noise, the codec callback, unsharp, auto
levels, fringes, quantisation, dithering, median, bilateral, CLAHE, SOM)
are not ported yet: ``not_ported`` raises for them and names ROADMAP
Queue A 5.2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.graphs import device_constant
from .blur import blur_per_sample
from .imresize import imresize, jax_resize

Params = Dict[str, Optional[torch.Tensor]]

NOT_PORTED_ITEM = "ROADMAP Queue A 5.2, the other preset strategies"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({NOT_PORTED_ITEM})")


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def draw_choice(gen: torch.Generator, b: int, n: int,
                weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-sample index in [0, n): uniform, or with the given weights."""
    if weights is not None:
        pw = device_constant(tuple(float(w) for w in weights),
                             torch.float32, gen.device)
        return torch.multinomial((pw / pw.sum()).expand(b, n), 1,
                                 generator=gen)[:, 0]
    return torch.randint(0, n, (b,), generator=gen, device=gen.device)


def select(cands: Sequence[torch.Tensor], choice: torch.Tensor
           ) -> torch.Tensor:
    """Per-sample pick among same-shaped candidates (b, ...)."""
    if len(cands) == 1:
        return cands[0]
    stack = torch.stack(list(cands), dim=1)
    return stack[torch.arange(stack.shape[0], device=stack.device), choice]


# ---------------------------------------------------------------------------
# kernel banks: (b, k, k), each kernel summing to 1
# ---------------------------------------------------------------------------


def _grid(k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ax = torch.arange(k, dtype=torch.float32, device=device) - (k - 1) / 2.0
    gx, gy = torch.meshgrid(ax, ax, indexing="xy")
    return gx, gy


def draw_support_sizes(gen: torch.Generator, b: int, k: int,
                       min_size: int) -> Optional[torch.Tensor]:
    """Per-sample kernel size v in [min_size, k], (b, 1, 1) int64; None
    when min_size >= k (full support)."""
    if min_size >= k:
        return None
    return torch.randint(min_size, k + 1, (b, 1, 1), generator=gen,
                         device=gen.device)


def _random_support_mask(v: Optional[torch.Tensor], k: int, device
                         ) -> torch.Tensor:
    """Support mask on the k x k grid of a per-sample size (an even v is
    raised to v + 1); ones when ``v`` is None."""
    if v is None:
        return torch.ones((1, 1, 1), dtype=torch.float32, device=device)
    gx, gy = _grid(k, device)
    sizes = v + (v % 2 == 0)
    half = (sizes - 1) / 2.0
    return ((gx.abs()[None] <= half) & (gy.abs()[None] <= half)).float()


def draw_gaussian_kernels(gen: torch.Generator, b: int, k: int = 21,
                          sigma_range: Tuple[float, float] = (0.2, 3.0),
                          iso_prob: float = 1.0,
                          sigma_y_range: Optional[Tuple[float, float]] = None,
                          min_size: Optional[int] = None,
                          angle_range: Optional[Tuple[float, float]] = None
                          ) -> Params:
    """sx, sy, theta (b,) and the support size of each sample's kernel."""
    sx = _uniform(gen, (b,), *sigma_range)
    sy_a = _uniform(gen, (b,), *(sigma_y_range or sigma_range))
    iso = _uniform(gen, (b,)) < iso_prob
    theta_a = _uniform(gen, (b,), *(angle_range or (-math.pi, math.pi)))
    support = draw_support_sizes(gen, b, k, min_size) \
        if min_size is not None else None
    return {"sx": sx, "sy": torch.where(iso, sx, sy_a),
            "theta": torch.where(iso, torch.zeros_like(theta_a), theta_a),
            "support": support}


def gaussian_kernels(params: Params, k: int = 21) -> torch.Tensor:
    """Rotated iso/anisotropic gaussian kernels, truncated to each sample's
    support size and renormalised."""
    sx, sy, theta = params["sx"], params["sy"], params["theta"]
    gx, gy = _grid(k, sx.device)
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    xr = ct * gx + st * gy
    yr = -st * gx + ct * gy
    kern = torch.exp(-0.5 * ((xr / sx[:, None, None]) ** 2 +
                             (yr / sy[:, None, None]) ** 2))
    if params.get("support") is not None:
        kern = kern * _random_support_mask(params["support"], k, sx.device)
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def draw_sinc_kernels(gen: torch.Generator, b: int, k: int = 21,
                      cutoff_range: Optional[Tuple[float, float]] = None,
                      min_size: Optional[int] = None) -> Params:
    """With ``cutoff_range`` the cutoff ``wc`` (b, 1, 1) within it and the
    full k x k support; without, a per-sample support size in [min_size
    (default 7), k] and ``u`` (b,) in [0, 1), which ``sinc_kernels`` turns
    into a cutoff in [pi / 3 or pi / 5, pi) by the support's size."""
    if cutoff_range is not None:
        return {"wc": _uniform(gen, (b, 1, 1), *cutoff_range)}
    return {"u": _uniform(gen, (b,)),
            "support": draw_support_sizes(gen, b, k, min_size or 7)}


def _j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel J1 by the Abramowitz-Stegun 9.4.4 / 9.4.6 approximations."""
    small = x < 3.0
    xs = torch.where(small, x, torch.full_like(x, 3.0)) / 3.0
    x2 = xs * xs
    p_small = (0.5 - 0.56249985 * x2 + 0.21093573 * x2 ** 2
               - 0.03954289 * x2 ** 3 + 0.00443319 * x2 ** 4
               - 0.00031761 * x2 ** 5 + 0.00001109 * x2 ** 6) * x
    xl = torch.where(small, torch.full_like(x, 3.0), x)
    inv = 3.0 / xl
    f1 = (0.79788456 + 0.00000156 * inv + 0.01659667 * inv ** 2
          + 0.00017105 * inv ** 3 - 0.00249511 * inv ** 4
          + 0.00113653 * inv ** 5 - 0.00020033 * inv ** 6)
    th = xl - 2.35619449 + 0.12499612 * inv + 0.0000565 * inv ** 2 \
        - 0.00637879 * inv ** 3 + 0.00074348 * inv ** 4
    p_large = f1 * torch.cos(th) / torch.sqrt(xl)
    return torch.where(small, p_small, p_large)


def sinc_kernels(params: Params, k: int = 21) -> torch.Tensor:
    """Circular low-pass (sinc) kernels wc J1(wc r) / (2 pi r), wc^2 / 4 pi
    at r = 0, truncated to each sample's support and normalised to sum 1.
    Without a drawn ``wc`` the cutoff is min + u (pi - min), min = pi / 3
    for a support under 13 and pi / 5 from 13 on."""
    mask = None
    if "wc" in params:
        wc = params["wc"]
        device = wc.device
    else:
        u = params["u"]
        device = u.device
        if params["support"] is None:
            # a full support (min_size >= k): the JAX package reads the
            # size off its (b, 1, 1) mask of ones, which gives 1, so pi / 3
            min_cut = torch.full_like(u, math.pi / 3)
        else:
            mask = _random_support_mask(params["support"], k, device)
            sizes = mask[:, k // 2, :].sum(dim=-1)
            min_cut = torch.where(sizes < 13,
                                  torch.full_like(sizes, math.pi / 3),
                                  torch.full_like(sizes, math.pi / 5))
        wc = (min_cut + u * (math.pi - min_cut))[:, None, None]
    gx, gy = _grid(k, device)
    rr = torch.sqrt(gx * gx + gy * gy)[None].expand(wc.shape[0], k, k)
    center = wc * wc / (4 * math.pi)
    kern = torch.where(rr < 1e-6, center.expand_as(rr),
                       wc * _j1(wc * rr) / (2 * math.pi * rr))
    if mask is not None:
        kern = kern * mask
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def apply_kernels(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample spatially-invariant blur with reflect padding:
    x (b, h, w, c), kernels (b, k, k), cross-correlation for every k."""
    return blur_per_sample(x, kernels)


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def draw_gaussian_noise(gen: torch.Generator, shape,
                        sigma_range: Tuple[float, float] = (1.0, 25.0),
                        gray_prob: float = 0.4, mc_prob: float = 0.34
                        ) -> Params:
    """Per sample: sigma in 0-255 units, gray (one noise plane for all
    channels) with ``gray_prob``; among colour samples, per-channel sigma
    sqrt(U(range)) with ``mc_prob``. ``sig`` is (b, 1, 1, 1 or 3) in [0, 1]
    units, ``normal`` the standard normal field."""
    b = shape[0]
    sigma = _uniform(gen, (b, 1, 1, 1), *sigma_range) / 255.0
    sigma_mc = torch.sqrt(_uniform(gen, (b, 1, 1, 3), *sigma_range)) / 255.0
    normal = _normal(gen, tuple(shape))
    gray = _uniform(gen, (b, 1, 1, 1)) < gray_prob
    mc = ~gray & (_uniform(gen, (b, 1, 1, 1)) < mc_prob)
    return {"sig": torch.where(mc, sigma_mc, sigma), "gray": gray,
            "normal": normal}


def gaussian_noise(x: torch.Tensor, params: Params,
                   sigma_scale: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Additive gaussian noise; ``sigma_scale`` (b,) multiplies sigma."""
    sig, normal = params["sig"], params["normal"]
    if sigma_scale is not None:
        sig = sig * sigma_scale.reshape(-1, 1, 1, 1)
    noise = torch.where(params["gray"], normal[..., :1].expand_as(normal),
                        normal)
    return x + sig.to(x.dtype) * noise.to(x.dtype)


def draw_poisson_noise(gen: torch.Generator, shape,
                       scale_range: Tuple[float, float] = (0.5, 3.0)
                       ) -> Params:
    """Per sample the photon scale (b, 1, 1, 1) within ``scale_range``, and
    the standard normal field."""
    return {"scale": _uniform(gen, (shape[0], 1, 1, 1), *scale_range),
            "normal": _normal(gen, tuple(shape))}


def poisson_noise(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Shot noise by the Gaussian approximation of Poisson: x + sqrt(clip(x,
    0, 1) / 10^(4 / scale)) n; a larger scale means fewer photons."""
    vals = torch.pow(10.0, 4.0 / params["scale"])
    return x + torch.sqrt(x.clamp(0.0, 1.0) / vals).to(x.dtype) \
        * params["normal"].to(x.dtype)


# ---------------------------------------------------------------------------
# JPEG approximation in the DCT domain, per-sample quality
# ---------------------------------------------------------------------------

_DCT8 = np.zeros((8, 8), np.float32)
for _i in range(8):
    for _j in range(8):
        _DCT8[_i, _j] = math.sqrt((1 if _i == 0 else 2) / 8) * \
            math.cos((2 * _j + 1) * _i * math.pi / 16)

# Annex-K luminance and chrominance quantisation tables
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)
_RGB2YCC = np.array([[0.299, 0.587, 0.114],
                     [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], np.float32).T
_YCC2RGB = np.array([[1.0, 0.0, 1.402],
                     [1.0, -0.344136, -0.714136],
                     [1.0, 1.772, 0.0]], np.float32).T
_Y_OFFSET = np.array([128.0, 0.0, 0.0], np.float32)

# (name, device) -> a constant table on that device
_constants: Dict[tuple, torch.Tensor] = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _constants.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(globals()[name])).to(device)
        _constants[key] = t
    return t


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, h/8, w/8, c, 8, 8)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 5, 2, 4)


def _unblockify(x: torch.Tensor) -> torch.Tensor:
    b, hb, wb, c, _, _ = x.shape
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, hb * 8, wb * 8, c)


def _quality_scale(q: torch.Tensor) -> torch.Tensor:
    """IJG quality -> the tables' scale factor."""
    return torch.where(q < 50, 5000.0 / q, 200.0 - 2.0 * q) / 100.0


def _jpeg_channel(ch: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """DCT, quantise, inverse DCT of (b, h, w, 1); qtab (b,1,1,1,8,8)."""
    d = _const("_DCT8", ch.device)
    coef = d @ _blockify(ch) @ d.T
    coef_q = torch.round(coef / qtab) * qtab
    return _unblockify(d.T @ coef_q @ d)


def upsample2x_linear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (b, h, w, c) with half-pixel centres, the
    chroma upsample of ``jpeg_compress``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def draw_jpeg_quality(gen: torch.Generator, b: int,
                      quality_range: Tuple[float, float] = (30.0, 95.0)
                      ) -> torch.Tensor:
    return _uniform(gen, (b,), *quality_range)


def jpeg_compress(x: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG approximation with per-sample ``quality`` (b,): YCbCr, 8x8 DCT,
    hard quantisation; chroma at half resolution (4:2:0) when h and w are
    multiples of 16, else at full resolution. h, w multiples of 8."""
    b, h, w, c = x.shape
    if h % 8 or w % 8 or c != 3:
        raise ValueError(f"jpeg_compress needs RGB with h, w multiples of 8,"
                         f" got {tuple(x.shape)}")
    dev = x.device
    scale = _quality_scale(quality.float())[:, None, None]
    ycc = (x * 255.0) @ _const("_RGB2YCC", dev) - _const("_Y_OFFSET", dev)
    q_luma = (_const("_Q_LUMA", dev)[None] * scale).clamp(1.0, 255.0)[
        :, None, None, None]
    q_chroma = (_const("_Q_CHROMA", dev)[None] * scale).clamp(1.0, 255.0)[
        :, None, None, None]
    y_rec = _jpeg_channel(ycc[..., :1], q_luma)
    cc = ycc[..., 1:]
    if h % 16 == 0 and w % 16 == 0:
        cc_sub = 0.25 * (cc[:, ::2, ::2] + cc[:, 1::2, ::2]
                         + cc[:, ::2, 1::2] + cc[:, 1::2, 1::2])
        cb = _jpeg_channel(cc_sub[..., :1], q_chroma)
        cr = _jpeg_channel(cc_sub[..., 1:], q_chroma)
        cc_rec = upsample2x_linear(torch.cat([cb, cr], dim=-1))
    else:
        cb = _jpeg_channel(cc[..., :1], q_chroma)
        cr = _jpeg_channel(cc[..., 1:], q_chroma)
        cc_rec = torch.cat([cb, cr], dim=-1)
    ycc_rec = torch.cat([y_rec, cc_rec], dim=-1) + _const("_Y_OFFSET", dev)
    rgb = (ycc_rec @ _const("_YCC2RGB", dev)) / 255.0
    return rgb.clamp(0.0, 1.0).to(x.dtype)


# ---------------------------------------------------------------------------
# resize ops
# ---------------------------------------------------------------------------

# the reference's 77x codes -> the kernel names of ops/imresize
_MATLAB_CODES = {
    773: "linear", 774: "box", 775: "lanczos2", 776: "lanczos3",
    777: "cubic", 778: "mitchell", 779: "hermite", 780: "lanczos4",
    781: "lanczos5", 782: "bell", 783: "catrom", 784: "hanning",
    785: "hamming", 786: "gaussian", 787: "sinc2", 788: "sinc3",
    789: "sinc4", 790: "sinc5", 791: "blackman2", 792: "blackman3",
    793: "blackman4", 794: "blackman5",
    100: "box", 101: "box", 102: "linear", 103: "lanczos2", 104: "lanczos3",
}


# the cv2-style codes -> the methods of ``jax.image.resize``
_JAX_METHODS = {0: "nearest", 1: "linear", 2: "cubic", 3: "linear",
                4: "lanczos3", 5: "linear", 6: "nearest"}


def resize_batch(x: torch.Tensor, out_hw: Tuple[int, int],
                 algo: int = 777) -> torch.Tensor:
    """Resize of the whole batch with one algorithm code
    (``options/config.py::INTERP_CODES``): the MATLAB kernels of
    ``ops/imresize``, or for the cv2-style codes 0-6 the weights of
    ``jax.image.resize`` (``ops/imresize.py::jax_resize``). Code 3 (area)
    is an antialiased linear resize down and a plain linear one up; the
    others antialias when the height shrinks. Any other code is cubic."""
    if algo in _MATLAB_CODES:
        return imresize(x, out_shape=tuple(out_hw),
                        kernel=_MATLAB_CODES[algo])
    h = x.shape[1]
    if algo == 3 and out_hw[0] <= h:
        return jax_resize(x, out_hw, "linear", antialias=True)
    return jax_resize(x, out_hw, _JAX_METHODS.get(algo, "cubic"),
                      antialias=out_hw[0] < h)


def _int_algos(algos: Sequence) -> list:
    return [a for a in algos if isinstance(a, int)] or [2]


def random_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                  algos: Sequence[int],
                  choice: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample choice among resize algorithms: every candidate is
    computed and ``choice`` (b,) picks one per sample."""
    algos = _int_algos(algos)
    if len(algos) == 1:
        return resize_batch(x, out_hw, algos[0])
    return select([resize_batch(x, out_hw, a) for a in algos], choice)


def draw_resize_choice(gen: torch.Generator, b: int, algos: Sequence[int]
                       ) -> Optional[torch.Tensor]:
    n = len(_int_algos(algos))
    return draw_choice(gen, b, n) if n > 1 else None


def down_up(x: torch.Tensor, choices: Sequence[Optional[torch.Tensor]],
            scale_range: Tuple[float, float] = (1.0, 2.0),
            algos: Sequence[int] = (1, 2)) -> torch.Tensor:
    """Down then up again at the same size, through the range's midpoint
    factor; ``choices`` are the two per-sample algorithm picks."""
    b, h, w, c = x.shape
    f = (scale_range[0] + scale_range[1]) / 2.0
    mid = (max(8, int(h / f)), max(8, int(w / f)))
    y = random_resize(x, mid, algos, choices[0])
    return random_resize(y, (h, w), algos, choices[1])


def nearest_aligned_downscale(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Aligned nearest downsample: the top-left pixel of every cell."""
    return x[:, ::scale, ::scale, :]


# ---------------------------------------------------------------------------
# camera ISP noise: unprocess -> bayer mosaic -> shot and read noise ->
# demosaic -> process
# ---------------------------------------------------------------------------


def _mosaic_masks(h: int, w: int, device):
    """RGGB bayer masks, (h, w) each."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    r = ((yy % 2 == 0) & (xx % 2 == 0)).float()
    g = (((yy % 2 == 0) & (xx % 2 == 1)) |
         ((yy % 2 == 1) & (xx % 2 == 0))).float()
    b = ((yy % 2 == 1) & (xx % 2 == 1)).float()
    return r, g, b


_MALVAR_G_AT_RB = np.array([
    [0, 0, -1, 0, 0], [0, 0, 2, 0, 0], [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0], [0, 0, -1, 0, 0]], np.float32) / 8.0
_MALVAR_CROSS_H = np.array([  # R/B at G, same-colour neighbours horizontal
    [0, 0, 0.5, 0, 0], [0, -1, 0, -1, 0], [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0], [0, 0, 0.5, 0, 0]], np.float32) / 8.0
_MALVAR_CHECKER = np.array([  # R at B / B at R
    [0, 0, -1.5, 0, 0], [0, 2, 0, 2, 0], [-1.5, 0, 6, 0, -1.5],
    [0, 2, 0, 2, 0], [0, 0, -1.5, 0, 0]], np.float32) / 8.0
# the four 5x5 filters as one conv weight (4, 1, 5, 5)
_MALVAR_BANK = np.stack([_MALVAR_G_AT_RB, _MALVAR_CROSS_H,
                         _MALVAR_CROSS_H.T, _MALVAR_CHECKER])[:, None]


def _malvar_demosaic(bayer: torch.Tensor):
    """Malvar-He-Cutler demosaic of an RGGB plane (b, h, w) -> (r, g, b)
    full-resolution channels; reflect padding."""
    b, h, w = bayer.shape
    dev = bayer.device
    vp = F.pad(bayer[:, None], (2, 2, 2, 2), mode="reflect")
    g_hat, cross_h, cross_v, checker = F.conv2d(
        vp, _const("_MALVAR_BANK", dev)).unbind(dim=1)
    mr, mg, mb = _mosaic_masks(h, w, dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    g_row_r = ((yy % 2 == 0) & (xx % 2 == 1)).float()  # G in an R row
    g_row_b = ((yy % 2 == 1) & (xx % 2 == 0)).float()  # G in a B row
    green = bayer * mg + g_hat * (mr + mb)
    red = bayer * mr + cross_h * g_row_r + cross_v * g_row_b + checker * mb
    blue = bayer * mb + cross_h * g_row_b + cross_v * g_row_r + checker * mr
    return red, green, blue


# four XYZ -> camera matrices and the RGB -> XYZ matrices of two illuminants
_XYZ2CAMS = np.array([
    [[1.0234, -0.2969, -0.2266], [-0.5625, 1.6328, -0.0469],
     [-0.0703, 0.2188, 0.6406]],
    [[0.4913, -0.0541, -0.0202], [-0.613, 1.3513, 0.2906],
     [-0.1564, 0.2151, 0.7183]],
    [[0.838, -0.263, -0.0639], [-0.2887, 1.0725, 0.2496],
     [-0.0627, 0.1427, 0.5438]],
    [[0.6596, -0.2079, -0.0562], [-0.4782, 1.3016, 0.1933],
     [-0.097, 0.1581, 0.5181]]], np.float32)
_RGB2XYZ_D50 = np.array([[0.4360747, 0.3850649, 0.1430804],
                         [0.2225045, 0.7168786, 0.0606169],
                         [0.0139322, 0.0971045, 0.7141733]], np.float32)
_RGB2XYZ_D65 = np.array([[0.4124564, 0.3575761, 0.1804375],
                         [0.2126729, 0.7151522, 0.0721750],
                         [0.0193339, 0.1191920, 0.9503041]], np.float32)


def draw_camera_noise(gen: torch.Generator, shape,
                      shot_range: Tuple[float, float] = (1e-4, 0.012),
                      gain_range: Tuple[float, float] = (1.2, 2.4),
                      bg_range: Optional[Tuple[float, float]] = None
                      ) -> Params:
    b, h, w, _ = shape
    return {
        "wts": _uniform(gen, (b, 4, 1, 1), 1e-8, 1e8),
        "gain_normal": _normal(gen, (b, 1, 1)),
        "rg": _uniform(gen, (b, 1, 1), *gain_range),
        "bg": _uniform(gen, (b, 1, 1), *(bg_range or gain_range)),
        "log_shot": _uniform(gen, (b, 1, 1), math.log(shot_range[0]),
                             math.log(shot_range[1])),
        "read_normal": _normal(gen, (b, 1, 1)),
        "normal": _normal(gen, (b, h, w)),
    }


def camera_noise(x: torch.Tensor, params: Params, xyz_arr: str = "D50"
                 ) -> torch.Tensor:
    """Camera-ISP noise model: inverse smoothstep tonemap, gamma expansion,
    a random camera colour matrix (convex mix of four), safe inverse gains
    (with a brightness gain 1/N(0.8, 0.1) that the processing does not
    undo), RGGB mosaic, log-uniform shot and correlated read noise, white
    balance, malvar demosaic, the inverse colour matrix, gamma compression
    and smoothstep."""
    b, h, w, c = x.shape
    dev = x.device
    rg, bg = params["rg"], params["bg"]

    img = x.clamp(0.0, 1.0)
    img = 0.5 - torch.sin(torch.asin(1.0 - 2.0 * img) / 3.0)
    lin = torch.pow(img.clamp_min(1e-8), 2.2)
    wts = params["wts"]
    xyz2cam = (_const("_XYZ2CAMS", dev)[None] * wts).sum(dim=1) \
        / wts.sum(dim=1)
    rgb2xyz = _const("_RGB2XYZ_D50" if xyz_arr == "D50" else "_RGB2XYZ_D65",
                     dev)
    rgb2cam = xyz2cam @ rgb2xyz
    rgb2cam = rgb2cam / rgb2cam.sum(dim=-1, keepdim=True)
    cam2rgb = torch.linalg.inv_ex(rgb2cam).inverse
    lin = torch.einsum("bhwc,bdc->bhwd", lin, rgb2cam)
    rgb_gain = 1.0 / (0.8 + 0.1 * params["gain_normal"])
    inv_gains = torch.stack([1.0 / rg, torch.ones_like(rg), 1.0 / bg],
                            dim=-1) / rgb_gain[..., None]  # (b, 1, 1, 3)
    gray = lin.mean(dim=-1, keepdim=True)
    inflection = 0.9
    msk = ((gray - inflection).clamp_min(0.0) / (1.0 - inflection)) ** 2
    safe_gains = torch.maximum(msk + (1.0 - msk) * inv_gains, inv_gains)
    lin = (lin * safe_gains).clamp(0.0, 1.0)

    mr, mg, mb = _mosaic_masks(h, w, dev)
    bayer = lin[..., 0] * mr + lin[..., 1] * mg + lin[..., 2] * mb

    log_shot = params["log_shot"]
    shot = torch.exp(log_shot)
    read = torch.exp(2.18 * log_shot + 1.20 + 0.26 * params["read_normal"])
    var = bayer.clamp(0.0, 1.0) * shot + read
    bayer = bayer + torch.sqrt(var) * params["normal"]

    gains_plane = rg * mr[None] + torch.ones_like(rg) * mg[None] \
        + bg * mb[None]
    bayer = (bayer * gains_plane).clamp(0.0, 1.0)
    rgb = torch.stack(_malvar_demosaic(bayer), dim=-1)
    rgb = torch.einsum("bhwc,bdc->bhwd", rgb, cam2rgb)
    rgb = torch.pow(rgb.clamp(0.0, 1.0).clamp_min(1e-8), 1 / 2.2)
    rgb = rgb.clamp(0.0, 1.0)
    rgb = 3.0 * rgb ** 2 - 2.0 * rgb ** 3
    return rgb.to(x.dtype)
