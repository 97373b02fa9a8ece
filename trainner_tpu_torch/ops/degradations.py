"""Batched on-device degradation ops on NHWC tensors in [0, 1].

Counterpart of ``trainner_tpu/ops/degradations.py``: the kernel banks
(``_grid:33``, ``_random_support_mask:39``, ``gaussian_kernels:57``,
``sinc_kernels:90``, ``motion_kernels:143``, ``box_kernels:164``),
``apply_kernels:192``; the noises (``gaussian_noise:236``,
``poisson_noise:271``, ``speckle_noise:286``, ``salt_pepper_noise:298``);
the DCT tables and ``jpeg_compress:451``; the pixel filters
(``unsharp_mask:499``, ``auto_levels:513``, ``fringes:521``); quantisation
and dithering (``quantize_colors:543``, ``ordered_dither:548``,
``_luma:560``, ``_ign_threshold:565``, ``dither_batch:578``,
``kmeans_quantize:616``, ``som_quantize:1010``); the resizes
(``resize_batch:676``, ``random_resize:695``, ``down_up:711``,
``nearest_aligned_downscale:726``, and for the cv2-style codes 0-6
``jax.image.resize``, ``ops/imresize.py::jax_resize``); camera noise
(``_mosaic_masks:738``, ``_malvar_demosaic:760``, ``camera_noise:811``);
the exact nonlinear filters (``_window_stack:886``, ``median_blur:898``,
``bilateral_blur:905``) and CLAHE (``_rgb_to_lab_l:935``,
``clahe_batch:949``); and ``max_rgb``, the pipeline's maxrgb.

Every op works on the whole batch with per-sample parameters and is split
in two: ``draw_*(gen, b, ...)`` draws the parameters from an explicit
``torch.Generator`` (on the generator's device), and the op itself is a
deterministic function of its input and those parameters, so a test can
feed it another framework's draws. No op reads a value back to the host
(no ``.item()``, no output of a data-dependent size), so a CUDA graph can
capture every one. Nothing here records gradients: the producer runs
under ``torch.no_grad()``.

``apply_kernels`` has one result for every k, the cross-correlation with
reflect padding. On a CUDA tensor it launches the hand-written kernel
``csrc/blur_per_sample.cu``; on a CPU tensor it runs the plain version.

The JAX package's exact codec (``codec_compress_host:409``) is a host
callback through OpenCV: a CUDA graph cannot hold it and the card's
machine has no OpenCV. ``compression: webp`` runs the DCT approximation
under ``TRAINNER_DEVICE_WEBP=approx`` and raises without it
(``not_ported``, ROADMAP C 20); ``otf_mode: host`` runs the real codec per
sample on the host (``data/host_degradations.py``).
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

NOT_PORTED_ITEM = ("ROADMAP C 20: a host callback, which a CUDA graph "
                   "cannot hold; otf_mode: host runs the real codec on the "
                   "host")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} does not run on the device ({NOT_PORTED_ITEM})")


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


def draw_motion_kernels(gen: torch.Generator, b: int,
                        length_range: Tuple[float, float] = (3.0, 15.0)
                        ) -> Params:
    """The angle in [0, pi) and the length within ``length_range``, each
    (b, 1, 1)."""
    return {"theta": _uniform(gen, (b, 1, 1), 0.0, math.pi),
            "length": _uniform(gen, (b, 1, 1), *length_range)}


def motion_kernels(params: Params, k: int = 21) -> torch.Tensor:
    """Linear motion-blur kernels: an anti-aliased line through the centre
    at the drawn angle, weight clamp(1 - distance to the line), cut at half
    the drawn length along it."""
    theta, length = params["theta"], params["length"]
    gx, gy = _grid(k, theta.device)
    ct, st = torch.cos(theta), torch.sin(theta)
    d_perp = (-st * gx[None] + ct * gy[None]).abs()
    d_par = (ct * gx[None] + st * gy[None]).abs()
    w = (1.0 - d_perp).clamp(0.0, 1.0) * (d_par <= length / 2)
    w = w + 1e-12
    return w / w.sum(dim=(1, 2), keepdim=True)


def draw_box_kernels(gen: torch.Generator, b: int,
                     size_range: Tuple[int, int] = (3, 11)) -> Params:
    """An odd size within ``size_range`` per sample, (b, 1, 1) int64."""
    return {"size": torch.randint(size_range[0] // 2, size_range[1] // 2 + 1,
                                  (b, 1, 1), generator=gen,
                                  device=gen.device) * 2 + 1}


def box_kernels(params: Params, k: int = 21) -> torch.Tensor:
    """Average (box) kernels of each sample's odd size on the k x k grid."""
    sizes = params["size"]
    gx, gy = _grid(k, sizes.device)
    half = (sizes - 1) / 2
    w = ((gx.abs()[None] <= half) & (gy.abs()[None] <= half)).float()
    return w / w.sum(dim=(1, 2), keepdim=True)


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


def draw_speckle_noise(gen: torch.Generator, shape,
                       sigma_range: Tuple[float, float] = (0.01, 0.15)
                       ) -> Params:
    """Per sample sigma (b, 1, 1, 1) within ``sigma_range``, and the
    standard normal field."""
    return {"sigma": _uniform(gen, (shape[0], 1, 1, 1), *sigma_range),
            "normal": _normal(gen, tuple(shape))}


def speckle_noise(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Multiplicative noise x (1 + sigma n)."""
    return x * (1.0 + params["sigma"].to(x.dtype)
                * params["normal"].to(x.dtype))


def draw_salt_pepper_noise(gen: torch.Generator, shape,
                           amount_range: Tuple[float, float] = (0.001, 0.01)
                           ) -> Params:
    """Per sample the amount (b, 1, 1, 1) within ``amount_range``, and one
    uniform per pixel (b, h, w, 1)."""
    return {"amount": _uniform(gen, (shape[0], 1, 1, 1), *amount_range),
            "u": _uniform(gen, (*shape[:3], 1))}


def salt_pepper_noise(x: torch.Tensor, params: Params,
                      sp_ratio: float = 0.5) -> torch.Tensor:
    """Salt (1) where u < amount sp_ratio, pepper (0) where u > 1 - amount
    (1 - sp_ratio), on every channel of the pixel."""
    amount, u = params["amount"], params["u"]
    y = torch.where(u < amount * sp_ratio, 1.0, x)
    return torch.where(u > 1.0 - amount * (1.0 - sp_ratio), 0.0, y)


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
# pixel filters
# ---------------------------------------------------------------------------

UNSHARP_K = 11  # the size of unsharp_mask's gaussian kernels


def draw_unsharp_mask(gen: torch.Generator, b: int,
                      sigma_range: Tuple[float, float] = (1.0, 2.0),
                      amount_range: Tuple[float, float] = (0.5, 1.5)
                      ) -> Params:
    """The isotropic gaussian of each sample's blur (k 11, full support)
    and its amount (b, 1, 1, 1)."""
    return {"kernel": draw_gaussian_kernels(gen, b, UNSHARP_K, sigma_range),
            "amount": _uniform(gen, (b, 1, 1, 1), *amount_range)}


def unsharp_mask(x: torch.Tensor, params: Params) -> torch.Tensor:
    """x + amount (x - blur(x)), clipped to [0, 1]; the blur through
    ``apply_kernels``."""
    blurred = apply_kernels(x, gaussian_kernels(params["kernel"], UNSHARP_K))
    amount = params["amount"].to(x.dtype)
    return (x + amount * (x - blurred)).clamp(0.0, 1.0)


def _percentiles(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of each sample over (h, w, c), (b, 1, 1, 1), by
    linear interpolation between the sorted values (``jnp.percentile``'s
    default), its position computed in f32 as there."""
    flat = x.reshape(x.shape[0], -1).sort(dim=1).values
    n = flat.shape[1]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    lw = np.float32(1.0) - hw
    out = flat[:, lo] * float(lw) + flat[:, hi] * float(hw)
    return out.reshape(-1, 1, 1, 1)


def auto_levels(x: torch.Tensor, percent: float = 1.0) -> torch.Tensor:
    """A percentile contrast stretch of each image: its ``percent`` and
    100 - ``percent`` percentiles map to 0 and 1."""
    lo = _percentiles(x, percent)
    hi = _percentiles(x, 100.0 - percent)
    return ((x - lo) / (hi - lo).clamp_min(1e-6)).clamp(0.0, 1.0)


def draw_fringes(gen: torch.Generator, b: int, max_shift: int = 2
                 ) -> torch.Tensor:
    """Integer shifts (b, 2, 2) in [-max_shift, max_shift]: (dy, dx) of the
    red and of the blue channel."""
    return torch.randint(-max_shift, max_shift + 1, (b, 2, 2), generator=gen,
                         device=gen.device)


def fringes(x: torch.Tensor, shifts: torch.Tensor, max_shift: int = 2
            ) -> torch.Tensor:
    """Chromatic aberration: the red and blue channels rolled by each
    sample's integer shifts, every shift computed and one kept per
    sample."""
    def shift_chan(chan, s):  # chan (b, h, w), s (b, 2)
        out = torch.zeros_like(chan)
        for dy in range(-max_shift, max_shift + 1):
            for dx in range(-max_shift, max_shift + 1):
                sel = ((s[:, 0] == dy) & (s[:, 1] == dx))[:, None, None]
                out = out + torch.where(
                    sel, torch.roll(chan, (dy, dx), dims=(1, 2)), 0.0)
        return out

    r = shift_chan(x[..., 0], shifts[:, 0])
    bch = shift_chan(x[..., 2], shifts[:, 1])
    return torch.stack([r, x[..., 1], bch], dim=-1)


def max_rgb(x: torch.Tensor) -> torch.Tensor:
    """Every channel of a pixel set to its largest one (``maxrgb``)."""
    return x.amax(dim=-1, keepdim=True).expand_as(x).contiguous()


# ---------------------------------------------------------------------------
# quantisation and dithering
# ---------------------------------------------------------------------------

_BAYER4 = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                    [3, 11, 1, 9], [15, 7, 13, 5]], np.float32) / 16.0


def quantize_colors(x: torch.Tensor, levels: int = 32) -> torch.Tensor:
    """Uniform colour quantisation to ``levels`` levels per channel."""
    return torch.round(x * (levels - 1)) / (levels - 1)


def _bayer_tiles(h: int, w: int, device) -> torch.Tensor:
    return _const("_BAYER4", device).repeat(h // 4 + 1, w // 4 + 1)[:h, :w]


def ordered_dither(x: torch.Tensor, bits: int = 1) -> torch.Tensor:
    """Bayer 4 x 4 ordered dithering."""
    b, h, w, c = x.shape
    tiles = _bayer_tiles(h, w, x.device) - 0.5
    levels = 2 ** bits
    return (torch.round((x + tiles[None, :, :, None] / levels)
                        * (levels - 1)) / (levels - 1)).clamp(0.0, 1.0)


def _luma(x: torch.Tensor) -> torch.Tensor:
    """BT.601 luma (b, h, w, 1), the products added in channel order."""
    return x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587 + x[..., 2:3] * 0.114


def _ign_threshold(h: int, w: int, device) -> torch.Tensor:
    """The interleaved-gradient-noise threshold field in [0, 1), (h, w):
    the JAX package's parallel stand-in for Floyd-Steinberg error
    diffusion (a serial recurrence), with its blue-noise look."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    v = 52.9829189 * torch.remainder(0.06711056 * xs + 0.00583715 * ys, 1.0)
    return torch.remainder(v, 1.0)


def draw_dither(gen: torch.Generator, shape, kind: str = "bayer"
                ) -> Optional[torch.Tensor]:
    """The random threshold field (h, w) of kind 'rnd'; None for the
    others, which draw nothing."""
    if kind.lower() != "rnd":
        return None
    return _uniform(gen, tuple(shape[1:3]))


def _mean3(v: torch.Tensor) -> torch.Tensor:
    """The 3 x 3 mean with zero padding, the nine taps (each times 1/9)
    added row by row."""
    h, w = v.shape[1], v.shape[2]
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = vp[:, dy:dy + h, dx:dx + w] * (1.0 / 9.0)
            out = tap if out is None else out + tap
    return out


def dither_batch(x: torch.Tensor, kind: str = "bayer", bits: int = 1,
                 bw: bool = False, thr: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The dither family: 'bayer' ordered, 'fs' (and any other kind) the
    error-diffusion look by the IGN threshold, 'rnd' a random threshold
    (``thr`` from ``draw_dither``), 'avg' a threshold at the 3 x 3 local
    mean, 'bin' plain binarisation. ``bw`` dithers the luma and repeats it
    on every channel."""
    b, h, w, c = x.shape
    v = _luma(x) if bw else x
    levels = 2 ** bits
    kind = kind.lower()
    if kind == "bin":
        out = torch.round(v * (levels - 1)) / (levels - 1)
    elif kind == "avg":
        out = (v > _mean3(v)).to(v.dtype)
    else:
        if kind == "bayer":
            t = _bayer_tiles(h, w, x.device)
        elif kind == "rnd":
            t = thr
        else:
            t = _ign_threshold(h, w, x.device)
        t = (t[None, :, :, None] - 0.5) / levels
        out = (torch.round((v + t) * (levels - 1)) / (levels - 1)).clamp(
            0.0, 1.0)
    if bw:
        out = out.expand(b, h, w, c).contiguous()
    return out


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows of ``idx`` over n classes by a comparison (no check
    that reads the indices back)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _sq_dist(a: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared distances (b, s, k) of points a (b, s, c) to centers (b, k,
    c) by the expansion |a|^2 - 2 a.c + |c|^2."""
    return (a.square().sum(-1, keepdim=True)
            - 2.0 * torch.einsum("bsc,bkc->bsk", a, centers)
            + centers.square().sum(-1)[:, None, :])


def draw_kmeans_quantize(gen: torch.Generator, shape, sample: int = 1024
                         ) -> torch.Tensor:
    """The ``sample`` pixels (b, sample) the centres are fit on."""
    b, h, w, _ = shape
    return torch.randint(0, h * w, (b, sample), generator=gen,
                         device=gen.device)


def kmeans_quantize(x: torch.Tensor, idx: torch.Tensor, n_colors: int = 32,
                    iters: int = 8) -> torch.Tensor:
    """Palette quantisation by per-sample Lloyd k-means on the pixels
    ``idx`` (their first ``n_colors`` start the centres), assignments and
    centre updates as one-hot products; every pixel then takes its nearest
    centre (the first one on a tie)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    sub = torch.take_along_dim(flat, idx[..., None], dim=1)
    centers = sub[:, :n_colors]
    for _ in range(iters):
        onehot = _one_hot(_sq_dist(sub, centers).argmin(-1), n_colors,
                          x.dtype)
        tot = torch.einsum("bsk,bsc->bkc", onehot, sub)
        cnt = onehot.sum(dim=1)[..., None]
        centers = torch.where(cnt > 0, tot / cnt.clamp_min(1.0), centers)
    assign = _sq_dist(flat, centers).argmin(-1)
    return torch.take_along_dim(centers, assign[..., None], dim=1).reshape(
        b, h, w, c)


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


# ---------------------------------------------------------------------------
# exact nonlinear filters, CLAHE and SOM quantisation
# ---------------------------------------------------------------------------


def _window_stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """(b, h, w, c) -> (b, h, w, c, k * k) window values, reflect padding
    (cv2's default border)."""
    pad = k // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect").permute(
        0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    return torch.stack([xp[:, dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=-1)


def median_blur(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """The exact k x k median (k odd: the middle of the k^2 sorted window
    values), reflect padding. The middle of a sort, not ``torch.median``:
    the same values in less time (0.25 against 0.36 ms at (5, 128, 128, 3),
    k 3, on an H100 80GB HBM3 at 700 W; ``scripts/median_variants.py``)."""
    win = _window_stack(x, k)
    return win.sort(dim=-1).values[..., k * k // 2]


def bilateral_blur(x: torch.Tensor, k: int = 9, sigma_color: float = 75.0,
                   sigma_space: float = 75.0) -> torch.Tensor:
    """The exact bilateral filter of cv2: over a circular neighbourhood of
    radius k // 2, a gaussian weight of the distance times a gaussian
    weight of the L1 colour distance (the sum of the channels' absolute
    differences; ``sigma_color`` in 0-255 units), reflect padding. The
    taps are added one offset at a time, without a stack of the
    windows."""
    b, h, w, c = x.shape
    pad = k // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect").permute(
        0, 2, 3, 1)
    ax = np.arange(k, dtype=np.float32) - np.float32((k - 1) / 2.0)
    d2 = ax[None, :] ** 2 + ax[:, None] ** 2  # [dy, dx]
    w_space = np.exp(-d2 / np.float32(2.0 * (sigma_space ** 2)))
    sc = sigma_color / 255.0
    num = den = None
    for dy in range(k):
        for dx in range(k):
            if d2[dy, dx] > pad * pad:
                continue  # outside the circle: weight 0
            win = xp[:, dy:dy + h, dx:dx + w]
            l1 = (win - x).abs().sum(dim=-1, keepdim=True)
            wt = float(w_space[dy, dx]) * torch.exp(
                -(l1 * l1) / (2.0 * sc * sc))
            num = win * wt if num is None else num + win * wt
            den = wt if den is None else den + wt
    return num / den.clamp_min(1e-8)


# D65 sRGB -> XYZ (cv2's RGB2LAB on 8-bit images); the Y row gives L*
_RGB2XYZ_LAB = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]], np.float32)


def _rgb_to_lab_l(x: torch.Tensor) -> torch.Tensor:
    """CIELAB's L of RGB in [0, 1], scaled to [0, 1], (b, h, w)."""
    v = x.clamp(0.0, 1.0)
    lin = torch.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)
    wr, wg, wb = (float(a) for a in _RGB2XYZ_LAB[1])
    y = lin[..., 0] * wr + lin[..., 1] * wg + lin[..., 2] * wb
    fy = torch.where(y > 0.008856, y.clamp_min(0.0) ** (1.0 / 3.0),
                     7.787 * y + 16.0 / 116.0)
    return ((116.0 * fy - 16.0) / 100.0).clamp(0.0, 1.0)


def draw_clahe(gen: torch.Generator, clip_hi: float) -> torch.Tensor:
    """One clip limit for the batch, 0-d, within [1, clip_hi]."""
    return 1.0 + _uniform(gen, ()) * (clip_hi - 1.0)


def clahe_batch(x: torch.Tensor, clip_limit=2.0,
                grid: Tuple[int, int] = (8, 8), n_bins: int = 256
                ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of the LAB
    luminance (cv2's CLAHE): per tile a histogram of the bins (integer
    counts of a fixed size, so reruns are bit-equal), clipped at
    clip_limit * tile size / n_bins with the excess spread evenly, its
    cumulative sum as the tile's map; each pixel's new L interpolated
    bilinearly between its four nearest tiles' maps, and RGB scaled by
    the ratio of new to old L. ``clip_limit`` is a number or a 0-d tensor;
    h and w must be multiples of the grid."""
    b, h, w, c = x.shape
    gy, gx = grid
    th, tw = h // gy, w // gx
    dev = x.device
    lum = _rgb_to_lab_l(x) if c == 3 else x[..., 0]
    bins = (lum * (n_bins - 1)).to(torch.int32).clamp(0, n_bins - 1).long()
    tiles = bins.reshape(b, gy, th, gx, tw).permute(0, 1, 3, 2, 4).reshape(
        b, gy * gx, th * tw)
    counts = torch.zeros((b, gy * gx, n_bins), dtype=torch.int32, device=dev)
    counts.scatter_add_(2, tiles, torch.ones_like(tiles, dtype=torch.int32))
    hist = counts.float()

    clip = torch.clamp_min(torch.as_tensor(clip_limit, dtype=torch.float32,
                                           device=dev) * (th * tw) / n_bins,
                           1.0)
    excess = (hist - clip).clamp_min(0.0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, clip) + excess / n_bins
    lut = (hist.cumsum(dim=-1) / (th * tw)).clamp(0.0, 1.0).reshape(-1)

    yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = yy.floor().clamp(0, gy - 1).long()
    x0 = xx.floor().clamp(0, gx - 1).long()
    y1 = (y0 + 1).clamp(0, gy - 1)
    x1 = (x0 + 1).clamp(0, gx - 1)
    wy = (yy - y0).clamp(0.0, 1.0)[None, :, None]
    wx = (xx - x0).clamp(0.0, 1.0)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]

    def sample_lut(ty, tx):  # lut[b, ty[y], tx[x], bins[b, y, x]]
        tile = (bi * gy + ty[None, :, None]) * gx + tx[None, None, :]
        return lut[tile * n_bins + bins]

    new_l = (sample_lut(y0, x0) * (1 - wy) * (1 - wx)
             + sample_lut(y0, x1) * (1 - wy) * wx
             + sample_lut(y1, x0) * wy * (1 - wx)
             + sample_lut(y1, x1) * wy * wx)
    if c == 1:
        return new_l[..., None].to(x.dtype)
    ratio = (new_l / lum.clamp_min(1e-4))[..., None]
    return (x * ratio).clamp(0.0, 1.0).to(x.dtype)


def draw_som_quantize(gen: torch.Generator, shape, n_colors: int = 32,
                      n_samples: int = 1024) -> Params:
    """The training pixels (b, n_samples) and, among them, the nodes'
    starting pixels (b, n_colors)."""
    b, h, w, _ = shape
    return {"idx": torch.randint(0, h * w, (b, n_samples), generator=gen,
                                 device=gen.device),
            "init_idx": torch.randint(0, n_samples, (b, n_colors),
                                      generator=gen, device=gen.device)}


def som_quantize(x: torch.Tensor, params: Params, n_colors: int = 32,
                 n_iters: int = 10) -> torch.Tensor:
    """Colour quantisation by a batch-trained self-organising map: a 1-D
    lattice of ``n_colors`` nodes trained on the drawn pixels with a
    gaussian neighbourhood that shrinks from n / 4 to 0.5 (its width
    computed in f32), then each pixel maps to its best-matching node (the
    first one on a tie)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    train = torch.take_along_dim(flat, params["idx"][..., None], dim=1)
    nodes = torch.take_along_dim(train, params["init_idx"][..., None], dim=1)
    lattice = torch.arange(n_colors, dtype=torch.float32, device=x.device)
    for i in range(n_iters):
        frac = np.float32(i) / np.float32(max(n_iters - 1, 1))
        sigma = np.float32(n_colors / 4.0) * (np.float32(1.0) - frac) \
            + np.float32(0.5) * frac
        d = train[:, :, None] - nodes[:, None]
        bmu = d.square().sum(dim=-1).argmin(dim=-1)
        dist = lattice[None, None, :] - bmu[..., None].float()
        nb = torch.exp(-dist.square() / float(np.float32(2.0) * sigma ** 2))
        num = torch.einsum("bsk,bsc->bkc", nb, train)
        den = nb.sum(dim=1)[..., None]
        nodes = num / den.clamp_min(1e-8)
    d = flat[:, :, None] - nodes[:, None]
    bmu = d.square().sum(dim=-1).argmin(dim=-1)
    return torch.take_along_dim(nodes, bmu[..., None], dim=1).reshape(
        b, h, w, c).to(x.dtype)
