"""The port's on-device ``imresize`` (``trainner_tpu_torch/ops/imresize.py``)
against the JAX package's ``ops/imresize.py::imresize``: every kernel name,
down and up, odd sizes, batched and single images. Both contract the same
f32 weight matrices, in another order of summation: 1e-5 absolute on inputs
in [0, 1].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import imresize as jax_imresize
from trainner_tpu_torch.ops import imresize as port_imresize

torch.set_num_threads(2)

KERNELS = sorted(port_imresize._KERNELS)


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_the_port_has_every_kernel_of_the_jax_package():
    assert set(port_imresize._KERNELS) == set(jax_imresize._KERNELS)
    assert port_imresize._ALIASES == jax_imresize._ALIASES


@pytest.mark.parametrize("out_hw", [(9, 13), (51, 41)], ids=["down", "up"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_imresize_matches_jax(kernel, out_hw):
    x = _img((3, 37, 29, 3), seed=len(kernel))
    want = np.asarray(jax_imresize.imresize(jnp.asarray(x), out_shape=out_hw,
                                            kernel=kernel))
    got = port_imresize.imresize(torch.from_numpy(x), out_shape=out_hw,
                                 kernel=kernel)
    assert got.shape == (3, *out_hw, 3) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("shape", [(20, 28), (20, 28, 3), (2, 20, 28, 1)])
@pytest.mark.parametrize("scale", [0.25, 1.5])
def test_imresize_by_scale_on_every_rank(shape, scale):
    x = _img(shape, seed=3)
    want = np.asarray(jax_imresize.imresize(jnp.asarray(x), scale=scale))
    got = port_imresize.imresize(torch.from_numpy(x), scale=scale)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_imresize_without_antialiasing_and_without_clip():
    x = _img((2, 24, 24, 3), seed=4) * 2.0 - 0.5  # leaves [0, 1]
    for kw in ({"antialiasing": False}, {"clip": False}):
        want = np.asarray(jax_imresize.imresize(
            jnp.asarray(x), out_shape=(7, 11), **kw))
        got = port_imresize.imresize(torch.from_numpy(x), out_shape=(7, 11),
                                     **kw)
        assert np.abs(got.numpy() - want).max() <= 1e-5
    assert float(got.min()) < 0.0  # clip=False keeps what leaves [0, 1]


def test_uint8_input_is_rounded_and_clipped():
    x = (np.random.RandomState(5).rand(16, 20, 3) * 255).astype(np.uint8)
    want = np.asarray(jax_imresize.imresize(jnp.asarray(x), scale=0.5))
    got = port_imresize.imresize(torch.from_numpy(x), scale=0.5)
    assert got.dtype == torch.uint8
    # a value within 1e-5 of a half may round the other way
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_the_device_matrix_is_built_once_per_size_and_kernel():
    port_imresize._device_matrices.clear()
    x = torch.from_numpy(_img((2, 32, 32, 3)))
    for _ in range(3):
        port_imresize.imresize(x, out_shape=(36, 41), kernel="linear")
    assert len(port_imresize._device_matrices) == 2  # 32->36 and 32->41
    port_imresize.imresize(x, out_shape=(36, 41), kernel="cubic")
    assert len(port_imresize._device_matrices) == 4


def test_imresize_np_matches_the_tensor_path():
    x = _img((21, 33, 3), seed=6)
    got = port_imresize.imresize_np(x, 1 / 3)
    want = port_imresize.imresize(torch.from_numpy(x), 1 / 3).numpy()
    assert np.abs(got - want).max() <= 1e-5
    with pytest.raises(ValueError, match="unknown resize kernel"):
        port_imresize.imresize_np(x, 0.5, kernel="nope")


def test_cached_matrices_made_in_inference_mode_serve_autograd():
    """A resize first met under ``torch.inference_mode`` (an ``eval_step``)
    caches its weights; a later call that records gradients (CEM's
    downscale in a train step, PAN's and A2N's bilinear skips) reads the
    same cache entry and must still backpropagate."""
    import torch

    from trainner_tpu_torch.ops.imresize import imresize, jax_resize

    shape = (1, 28, 20, 3)
    with torch.inference_mode():
        imresize(torch.rand(shape), scale=0.25, clip=False)
        jax_resize(torch.rand(shape), (7, 5), "linear", False)
    x = torch.rand(shape, requires_grad=True)
    (imresize(x, scale=0.25, clip=False).sum()
     + jax_resize(x, (7, 5), "linear", False).sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
