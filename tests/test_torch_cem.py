"""The port's CEM (``trainner_tpu_torch/ops/cem.py``) against the JAX
package's ``ops/cem.py`` on the CPU: the ``box`` closed form and the
``cubic`` conjugate-gradient projection within 1e-5 (images in [0, 1]),
the projection's downscale consistency, its gradient; and the test CLI's
CEM branches (``out_orig``, ``out_filter``, ``out_keepY``) against the JAX
CLI, image for image (8-bit PNGs within one level)."""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test as jax_test_cli
from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu.ops import cem as jcem
from trainner_tpu.ops.colors import rgb_to_ycbcr as jax_rgb_to_ycbcr
from trainner_tpu.ops.colors import ycbcr_to_rgb as jax_ycbcr_to_rgb
from trainner_tpu.ops.filters import guided_filter as jax_guided_filter
from trainner_tpu.utils.checkpoint import save_params
from trainner_tpu_torch import test as port_test_cli
from trainner_tpu_torch.ops import cem
from trainner_tpu_torch.ops.colors import rgb_to_ycbcr, ycbcr_to_rgb
from trainner_tpu_torch.ops.filters import guided_filter

torch.set_num_threads(2)


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("kernel", ["box", "cubic"])
@pytest.mark.parametrize("scale,hw", [(4, (16, 12)), (2, (10, 14)),
                                      (3, (12, 9))])
def test_cem_project_matches_jax(kernel, scale, hw):
    sr = _img((2, *hw, 3), seed=1)
    lr = _img((2, hw[0] // scale, hw[1] // scale, 3), seed=2)
    want = np.asarray(jcem.cem_project(jnp.asarray(sr), jnp.asarray(lr),
                                       scale, kernel=kernel))
    got = cem.cem_project(torch.from_numpy(sr), torch.from_numpy(lr), scale,
                          kernel=kernel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("kernel,tol", [("box", 1e-6), ("cubic", 1e-4)])
def test_cem_output_downscales_to_the_lr(kernel, tol):
    """What CEM is for: the output's downscale equals the LR (box: to f32
    rounding; cubic: after 20 CG steps, within 1e-4 on [0, 1] images)."""
    sr = torch.from_numpy(_img((1, 16, 16, 3), seed=3))
    lr = torch.from_numpy(_img((1, 4, 4, 3), seed=4))
    out = cem.cem_project(sr, lr, 4, kernel=kernel)
    down = cem._box_down(out, 4) if kernel == "box" else \
        cem.downscale(out, 4, kernel)
    assert (down - lr).abs().max() < tol
    assert (cem.downscale(sr, 4) - lr).abs().max() > 0.1


def test_downscale_transpose_is_the_adjoint():
    """<D x, y> = <x, Dᵀ y>: the transposed matrices are D's adjoint, as
    the JAX package's vjp gives it."""
    x = torch.from_numpy(_img((2, 12, 16, 3), seed=5)).double()
    y = torch.from_numpy(_img((2, 3, 4, 3), seed=6)).double()
    dx = cem.downscale(x.float(), 4).double()
    dty = cem._downscale_transpose(y.float(), x.shape, 4, "cubic").double()
    assert abs(float((dx * y).sum() - (x * dty).sum())) < 1e-4
    _, vjp = jax.vjp(lambda a: jcem.downscale(a, 4), jnp.asarray(x.float()))
    want = np.asarray(vjp(jnp.asarray(y.float()))[0])
    assert np.abs(dty.numpy() - want).max() < 1e-6


@pytest.mark.parametrize("kernel", ["box", "cubic"])
def test_cem_gradient_matches_jax(kernel):
    sr = _img((1, 8, 12, 3), seed=7)
    lr = _img((1, 2, 3, 3), seed=8)
    g = _img((1, 8, 12, 3), seed=9) - 0.5
    want = jax.grad(lambda s: jnp.sum(jcem.cem_project(
        s, jnp.asarray(lr), 4, kernel=kernel) * g))(jnp.asarray(sr))
    st = torch.from_numpy(sr).requires_grad_(True)
    (cem.cem_project(st, torch.from_numpy(lr), 4, kernel=kernel)
     * torch.from_numpy(g)).sum().backward()
    assert np.abs(st.grad.numpy() - np.asarray(want)).max() < 1e-5


def test_cem_post_processing_ops_match_jax():
    a = _img((2, 9, 11, 3), seed=10)
    b = _img((2, 9, 11, 3), seed=11)
    np.testing.assert_allclose(
        guided_filter(torch.from_numpy(a), torch.from_numpy(b), 3).numpy(),
        np.asarray(jax_guided_filter(jnp.asarray(a), jnp.asarray(b), 3)),
        atol=1e-5)
    ycc = rgb_to_ycbcr(torch.from_numpy(a))
    np.testing.assert_allclose(ycc.numpy(), np.asarray(
        jax_rgb_to_ycbcr(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(ycbcr_to_rgb(ycc).numpy(), np.asarray(
        jax_ycbcr_to_rgb(jax_rgb_to_ycbcr(jnp.asarray(a)))), atol=1e-5)


def _flax_ckpt(path):
    """A small flax RRDBNet at unit gain (outputs of size ~1)."""
    net = JaxRRDBNet(nf=16, nb=1, nr=3, gc=8, upscale=4, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    v = net.init({"params": rng, "noise": rng}, jnp.zeros((1, 8, 8, 3)),
                 train=False)
    draw = np.random.RandomState(7)
    params = jax.tree.map(
        lambda a: ((draw.randn(*a.shape) / np.sqrt(np.prod(a.shape[:3])))
                   if a.ndim == 4 else draw.randn(*a.shape) * 0.05
                   ).astype(np.float32), v["params"])
    save_params(params, str(path))


def _options(tmp_path, name, ckpt, **extra):
    opt = {"name": name, "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                   "crop_size": 32, "n_samples": 2}},
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 8},
           "path": {"root": str(tmp_path), "pretrain_model_G": str(ckpt)},
           "metrics": "psnr,ssim", "use_cem": True, **extra}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(opt))
    return str(path)


@pytest.mark.parametrize("kernel,cem_config", [
    ("box", {}),
    ("box", {"out_orig": True, "out_keepY": True}),
    ("cubic", {"out_orig": True, "out_filter": True, "out_filter_ks": 5,
               "out_keepY": True}),
], ids=["box", "box-orig-keepY", "cubic-orig-filter-keepY"])
def test_port_cli_cem_branches_match_jax_cli(tmp_path, kernel, cem_config):
    ckpt = tmp_path / "G.ckpt"
    _flax_ckpt(ckpt)
    extra = {"cem": {"kernel": kernel}, "cem_config": cem_config}
    jax_test_cli.main(["-opt", _options(tmp_path, "jax", ckpt, **extra)])
    port_test_cli.main(["-opt", _options(tmp_path, "port", ckpt, **extra)],
                       device="cpu")
    plain = port_test_cli.main(["-opt", _options(
        tmp_path, "plain", ckpt, use_cem=False)], device="cpu")
    assert plain
    moved = 0
    for i in range(2):
        a, b, c = (cv2.imread(str(tmp_path / "results" / run / "synth"
                                  / f"{i}.png"))
                   for run in ("jax", "port", "plain"))
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        moved += int(np.abs(b.astype(int) - c.astype(int)).max() > 2)
    assert moved == 2  # CEM changed what the CLI wrote
