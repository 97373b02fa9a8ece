"""The port's per-sample blur (``trainner_tpu_torch/ops/blur.py``, reached
through ``ops/degradations.py::apply_kernels``) against the JAX package:
the conv path of ``apply_kernels`` (``TRAINNER_BLUR_FFT=0``; the FFT path
it takes by default for k >= 13 flips the kernel and sizes itself from h
alone) and the Pallas kernel ``blur_per_sample_pallas`` in interpret mode.
On the CPU the port runs its plain PyTorch version; the CUDA kernel is held
to that version on the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 absolute on inputs in [0, 1] (up to 441 products
summed in another order); bf16 one bf16 ulp of the output (both sum in f32
and round once).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops.degradations import apply_kernels as jax_apply
from trainner_tpu.ops.pallas_kernels import blur_per_sample_pallas
from trainner_tpu_torch.ops import blur as port_blur
from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                         blur_per_sample_plain)
from trainner_tpu_torch.ops.degradations import apply_kernels

torch.set_num_threads(2)

B, H, W = 7, 23, 31  # non-square; k // 2 = 10 < 23


def _inputs(k, c, seed=0):
    rng = np.random.RandomState(seed + 100 * k + c)
    x = rng.rand(B, H, W, c).astype(np.float32)
    kern = rng.rand(B, k, k).astype(np.float32) ** 3  # asymmetric
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    return x, kern


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side's conv path, for the length of one test."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("k", [3, 7, 13, 21])
def test_blur_f32_matches_jax_conv_path_and_pallas(k, c):
    x, kern = _inputs(k, c)
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(kern)))
    pallas = np.asarray(blur_per_sample_pallas(
        jnp.asarray(x), jnp.asarray(kern), interpret=True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(kern)
    for fn in (blur_per_sample_plain, blur_per_sample, apply_kernels):
        got = fn(xt, kt)
        assert got.shape == (B, H, W, c) and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5
        assert np.abs(got.numpy() - pallas).max() <= 1e-5


def test_blur_is_cross_correlation_not_convolution():
    """A one-hot kernel off the centre shifts the image one way only."""
    x, _ = _inputs(5, 3)
    kern = np.zeros((B, 5, 5), np.float32)
    kern[:, 1, 4] = 1.0  # dy = -1, dx = +2
    got = apply_kernels(torch.from_numpy(x), torch.from_numpy(kern)).numpy()
    np.testing.assert_array_equal(got[:, 1:, :-2], x[:, :-1, 2:])
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(kern)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [7, 21])
def test_blur_bf16_within_one_ulp(k):
    x, kern = _inputs(k, 3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(blur_per_sample_pallas(
        xb, jnp.asarray(kern), interpret=True).astype(jnp.float32))
    got = apply_kernels(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(kern))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_kernel_is_exact(dtype):
    x, _ = _inputs(9, 3)
    xt = torch.from_numpy(x).to(dtype)
    ident = torch.zeros(B, 9, 9)
    ident[:, 4, 4] = 1.0
    assert torch.equal(apply_kernels(xt, ident), xt)


def test_even_k_and_too_large_k_raise():
    x = torch.rand(2, 8, 12, 3)
    with pytest.raises(ValueError, match="odd"):
        apply_kernels(x, torch.rand(2, 4, 4))
    with pytest.raises(ValueError, match="reflect"):
        apply_kernels(x, torch.rand(2, 17, 17))  # 17 // 2 = 8 >= min(h, w)
    with pytest.raises(ValueError, match="kernels must be"):
        apply_kernels(x, torch.rand(3, 5, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        apply_kernels(x.double(), torch.rand(2, 5, 5))


def test_cpu_tensors_never_count_as_launches():
    before = port_blur.launches
    x, kern = _inputs(3, 1)
    blur_per_sample(torch.from_numpy(x), torch.from_numpy(kern))
    assert port_blur.launches == before


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper goes to the kernel's library or raises;
    shown here by the device type alone (no card is needed)."""
    called = []
    monkeypatch.setattr(port_blur, "blur_per_sample_plain",
                        lambda *a: called.append(1))
    monkeypatch.setattr(port_blur, "_library",
                        lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))

    class FakeCuda:
        type = "cuda"

    class FakeTensor:
        device = FakeCuda()
        dtype = torch.float32
        shape = (2, 8, 8, 3)

        def dim(self):
            return 4

        def contiguous(self):
            return self

        def float(self):
            return self

    x, kern = FakeTensor(), FakeTensor()
    kern.shape = (2, 3, 3)
    kern.dim = lambda: 3
    with pytest.raises(RuntimeError, match="no nvcc"):
        blur_per_sample(x, kern)
    assert not called
