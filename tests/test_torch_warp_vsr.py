"""The video models' warps and resizes (``trainner_tpu_torch/ops/warp.py``,
``ops/blocks.py::resize_torch``), the geometry ops (``ops/geometry.py``)
and the flow utilities (``utils/flow_utils.py``) against the JAX package on
the CPU: values f32 within 1e-5 and the flow's gradient within 1e-5 of its
size, on numpy-seeded inputs with flows that reach past the border.

ROADMAP C 25, held here: a warp whose image needs no gradient (SOF-VSR's
frames) and the flow's upsample backpropagate through no gather, scatter
or interpolation kernel, so the card adds their gradients in a fixed order
(no atomics) and a graphed step equals its eager run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import blocks as JB
from trainner_tpu.ops import geometry as JG
from trainner_tpu.ops import warp as JW
from trainner_tpu.utils import flow_utils as JF
from trainner_tpu_torch.ops import geometry as PG
from trainner_tpu_torch.ops import warp as PW
from trainner_tpu_torch.ops.blocks import resize_torch
from trainner_tpu_torch.utils import flow_utils as PF

torch.set_num_threads(2)


def _inputs(seed=0, h=12, w=10, c=3, spread=2.0):
    rng = np.random.RandomState(seed)
    img = rng.rand(2, h, w, c).astype(np.float32)
    flow = (rng.randn(2, h, w, 2) * spread).astype(np.float32)
    return img, flow


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("case", ["vsr", "pix_zeros", "pix_border"])
def test_warp_and_its_flow_gradient_match_jax(case):
    img, flow = _inputs(1)
    if case == "vsr":
        jfn, pfn = JW.flow_warp_vsr, PW.flow_warp_vsr
    else:
        mode = case.split("_")[1]
        jfn = lambda i, f: JW.flow_warp_pix(i, f, mode)  # noqa: E731
        pfn = lambda i, f: PW.flow_warp_pix(i, f, mode)  # noqa: E731
    weights = np.random.RandomState(2).rand(*img.shape).astype(np.float32)
    want = jfn(jnp.asarray(img), jnp.asarray(flow))
    jgrad = jax.grad(lambda f: jnp.sum(jfn(jnp.asarray(img), f) * weights))(
        jnp.asarray(flow))
    f = torch.from_numpy(flow).requires_grad_(True)
    got = pfn(torch.from_numpy(img), f)
    (got * torch.from_numpy(weights)).sum().backward()
    _close(got.detach(), want)
    _close(f.grad, jgrad)


def test_warp_image_gradient_matches_jax():
    """EDVR's and RIFE's warps carry a gradient to the features too."""
    img, flow = _inputs(3)
    weights = np.random.RandomState(4).rand(*img.shape).astype(np.float32)
    jgrad = jax.grad(lambda i: jnp.sum(JW.flow_warp_pix(
        i, jnp.asarray(flow), "zeros") * weights))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    (PW.flow_warp_pix(x, torch.from_numpy(flow), "zeros")
     * torch.from_numpy(weights)).sum().backward()
    _close(x.grad, jgrad)


def _backward_nodes(out):
    seen, todo, names = set(), [out.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_frame_warp_and_flow_upsample_backpropagate_without_scatter():
    img, flow = _inputs(5)
    f = torch.from_numpy(flow).requires_grad_(True)
    out = PW.flow_warp_vsr(torch.from_numpy(img), resize_torch(f, scale=2)[
        :, ::2, ::2])
    names = _backward_nodes(out.sum())
    assert not [n for n in names if "Gather" in n or "Scatter" in n
                or "Upsample" in n or "Index" in n], names


@pytest.mark.parametrize("mode,scale,size", [
    ("bilinear", 2, None), ("bilinear", 4, None), ("bilinear", None, (12, 8)),
    ("bicubic", 4, None), ("bicubic", 0.5, None)])
def test_torch_resizes_match_jax(mode, scale, size):
    x = np.random.RandomState(6).randn(2, 6, 4, 3).astype(np.float32)
    if size is not None:
        x = np.random.RandomState(6).randn(2, 6, 4, 2).astype(np.float32)
    jfn = JB.bilinear_torch if mode == "bilinear" else JB.bicubic_torch
    want = jfn(jnp.asarray(x), scale=scale, size=size)
    _close(resize_torch(torch.from_numpy(x), scale=scale, size=size,
                        mode=mode), want)
    t = torch.from_numpy(x).requires_grad_(True)
    out = resize_torch(t, scale=scale, size=size, mode=mode)
    w = np.random.RandomState(7).rand(*out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jfn(v, scale=scale, size=size) * w))(
        jnp.asarray(x))
    _close(t.grad, jgrad)


def test_rotations_and_perspective_match_jax_given_its_draws():
    x = np.random.RandomState(8).rand(3, 16, 12, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    angles = np.asarray(jax.random.uniform(key, (3,), minval=-45.0,
                                           maxval=45.0))
    for crop in (True, False):
        want = JG.rotate_batch(key, jnp.asarray(x), 45.0, crop)
        got = PG.rotate_batch(torch.from_numpy(x), 45.0, crop,
                              angles=torch.from_numpy(angles))
        _close(got, want)
    lr = x[:, ::2, ::2]
    a_key, _ = jax.random.split(key)
    pair_angles = np.asarray(jax.random.uniform(a_key, (3,), minval=-30.0,
                                                maxval=30.0))
    jh, jl = JG.rotate_pair(key, jnp.asarray(x), jnp.asarray(lr), 30.0)
    ph, pl = PG.rotate_pair(torch.from_numpy(x), torch.from_numpy(lr), 30.0,
                            angles=torch.from_numpy(pair_angles))
    _close(ph, jh)
    _close(pl, jl)
    jitter = np.asarray(jax.random.uniform(key, (3, 4, 2), minval=-0.2,
                                           maxval=0.2))
    want = JG.perspective_batch(key, jnp.asarray(x), 0.2)
    got = PG.perspective_batch(torch.from_numpy(x), 0.2,
                               jitter=torch.from_numpy(jitter))
    _close(got, want, 1e-4)
    drawn = PG.rotate_batch(torch.from_numpy(x), 45.0,
                            generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape and torch.isfinite(drawn).all()


def test_flow_utils_match_jax(tmp_path):
    _, flow = _inputs(9, 9, 11)
    flow = flow[0]
    for max_flow in (None, 1.5):
        np.testing.assert_array_equal(PF.flow2rgb(flow, max_flow),
                                      JF.flow2rgb(flow, max_flow))
    PF.write_flo(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(JF.read_flo(str(tmp_path / "a.flo")),
                                  flow)
    JF.write_flo(str(tmp_path / "b.flo"), flow)
    np.testing.assert_array_equal(PF.read_flo(str(tmp_path / "b.flo")),
                                  flow)
    (tmp_path / "c.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="tag"):
        PF.read_flo(str(tmp_path / "c.flo"))
