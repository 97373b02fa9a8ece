"""The port's ``VGGFeatures`` (``trainner_tpu_torch/models/perceptual.py``)
against the JAX module on carried random weights, f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models import perceptual as jax_perceptual
from trainner_tpu_torch.models.perceptual import (VGGFeatures,
                                                  canonical_layer,
                                                  load_vgg_npz,
                                                  vgg_layer_names)
from trainner_tpu_torch.utils.torch_interop import vgg_from_jax

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)


def _pair(listen, arch="vgg19", **kw):
    mod = jax_perceptual.VGGFeatures(arch=arch, listen=tuple(listen), **kw)
    variables = mod.init({"params": jax.random.PRNGKey(7)},
                         jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, jax.device_get(variables["params"]))
    net = VGGFeatures(arch=arch, listen=listen, **kw)
    net.load_state_dict(vgg_from_jax(params), strict=False)
    return mod, variables, net


def _images(seed=0, n=2):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


def _check(mod, variables, net, x, tol):
    want = mod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32
        assert np.abs(got[k].numpy() - w).max() <= tol * np.abs(w).max(), k


def test_vgg19_conv5_4_matches_jax():
    """The ESRGAN feature, conv5_4 before the ReLU at 32 px, through 16
    f32 convs: within 1e-5 of the feature's largest magnitude."""
    _check(*_pair(["conv5_4"]), _images(), 1e-5)


def test_relu_taps_early_exit_and_z_norm():
    """Pre- and post-activation taps, the early exit after block 3 (no
    parameter of blocks 4-5 is touched), and [-1, 1] inputs."""
    mod, variables, net = _pair(["relu3_2", "conv_2_1", "conv1_2"],
                                z_norm=True)
    assert net.wanted == {"relu:conv3_2", "conv2_1", "conv1_2"}
    with torch.no_grad():
        net.conv4_1.weight.fill_(float("nan"))
    _check(mod, variables, net, _images(1) * 2 - 1, 1e-5)


def test_vgg16_without_input_norm():
    """VGG16 without the input normalisation, at conv4_3's ReLU tap. The
    JAX package's ``canonical_layer`` turns the spelling 'relu:conv4_3'
    into a name no tap has, so its module returned nothing for it and this
    test compared two empty outputs (ROADMAP C 18); the JAX side now
    listens at 'relu4_3', and the port's at either spelling."""
    mod, variables, net = _pair(["relu4_3"], arch="vgg16",
                                use_input_norm=False)
    assert net.wanted == {"relu:conv4_3"} == {
        canonical_layer("relu:conv4_3")}
    _check(mod, variables, net, _images(2), 1e-5)


def test_bf16_body_normalises_the_input_in_f32():
    """bf16 body, f32 input normalisation before the cast: within 3 % of
    the JAX bf16 module's conv2_2 feature."""
    mod, variables, net = _pair(["conv2_2"], dtype=jnp.bfloat16)
    net.dtype = torch.bfloat16
    _check(mod, variables, net, _images(3), 3e-2)


@pytest.mark.parametrize("name", ["conv_3_2", "conv3_2", "relu3_2", "conv54",
                                  "relu-5-4", "Conv5_4"])
def test_canonical_layer_matches_jax(name):
    assert canonical_layer(name) == jax_perceptual.canonical_layer(name)


@pytest.mark.parametrize("arch", ["vgg11", "vgg13", "vgg16", "vgg19"])
def test_layer_names_match_jax(arch):
    assert vgg_layer_names(arch) == jax_perceptual.vgg_layer_names(arch)


def test_load_vgg_npz_reads_the_jax_package_file_format(tmp_path):
    """An .npz in the converted-torchvision format loads to the same
    features as the JAX loader's params."""
    mod, variables, _ = _pair(["conv2_1"])
    flat = {f"{layer}/{leaf}": np.asarray(v)
            for layer, node in variables["params"].items()
            for leaf, v in node.items()}
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **flat)
    net = VGGFeatures(listen=["conv2_1"])
    net.load_state_dict(load_vgg_npz(path), strict=False)
    _check(mod, jax_perceptual.load_vgg_npz(path), net, _images(4), 1e-5)
