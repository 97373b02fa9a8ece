"""The port's ``DiscriminatorVGG`` and its flax-like ``BatchNorm``
(``trainner_tpu_torch/models/discriminators.py``, ``ops/blocks.py``)
against the JAX module on carried weights, f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.discriminators import DiscriminatorVGG as JaxD
from trainner_tpu_torch.models.discriminators import DiscriminatorVGG
from trainner_tpu_torch.models.networks import define_D
from trainner_tpu_torch.ops.blocks import BatchNorm, ConvBlock
from trainner_tpu_torch.utils.torch_interop import discriminator_from_jax

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)

SIZE, BASE_NF, BATCH = 32, 8, 4


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_d(seed=0, dtype=jnp.float32):
    """The JAX module with weights, norm scales and running statistics
    redrawn from a numpy seed (the init's unit scales and zero means would
    hide a swapped leaf)."""
    mod = JaxD(size=SIZE, base_nf=BASE_NF, dtype=dtype)
    variables = mod.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.randn(*shape).astype(np.float32) / np.sqrt(fan_in)
        if name in ("scale", "var"):
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(redraw, _numpy_tree(variables))
    return mod, variables


def _port_d(variables, dtype=torch.float32):
    net = DiscriminatorVGG(size=SIZE, base_nf=BASE_NF, dtype=dtype)
    net.load_state_dict(discriminator_from_jax(variables["params"],
                                               variables["batch_stats"]),
                        strict=True)
    return net


def _images(seed=1):
    return np.random.RandomState(seed).rand(BATCH, SIZE, SIZE, 3).astype(
        np.float32)


def test_eval_forward_matches_jax_with_feats():
    """Eval mode (running statistics), logits and every feature map within
    1e-5 of the JAX module: f32 convs summed in another order."""
    mod, variables = _jax_d()
    x = _images()
    want, want_feats = mod.apply(variables, jnp.asarray(x), train=False,
                                 return_feats=True)
    net = _port_d(variables)
    with torch.no_grad():
        got, feats = net(torch.from_numpy(x), train=False, return_feats=True)
    assert got.shape == (BATCH, 1) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    assert len(feats) == len(want_feats) == 3
    for f, w in zip(feats, want_feats):
        assert tuple(f.shape) == w.shape
        assert np.abs(f.numpy() - np.asarray(w)).max() < 1e-5


def test_train_forward_and_running_statistics_match_jax():
    """Train mode: batch statistics in the forward (logits within 1e-4:
    the normalisation divides by small batch deviations), and the running
    statistics that the pass would write equal flax's (momentum 0.99, the
    biased batch variance) within 1e-6. The pass itself writes nothing;
    commit_stats does."""
    mod, variables = _jax_d(seed=2)
    x = _images(seed=3)
    want, new_vars = mod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    net = _port_d(variables)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        got = net(torch.from_numpy(x), train=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    net.commit_stats()
    want_sd = discriminator_from_jax(variables["params"],
                                     _numpy_tree(new_vars["batch_stats"]))
    moved = 0
    for k, v in net.state_dict().items():
        assert np.abs(v.numpy() - want_sd[k].numpy()).max() < 1e-6, k
        moved += int(not torch.equal(v, before[k]))
    assert moved == 2 * len(net.norms()) == 10


def test_two_passes_keep_the_last_statistics():
    """Two train-mode passes then one commit: both start from the same
    running statistics and the second pass's are kept, as the JAX
    trainer's D stage keeps the real batch's."""
    _, variables = _jax_d(seed=4)
    net = _port_d(variables)
    a, b = torch.from_numpy(_images(5)), torch.from_numpy(_images(6))
    with torch.no_grad():
        net(a, train=True)
        net(b, train=True)
        net.commit_stats()
        twice = {k: v.clone() for k, v in net.state_dict().items()}
        net = _port_d(variables)
        net(b, train=True)
        net.commit_stats()
    for k, v in net.state_dict().items():
        assert torch.equal(v, twice[k]), k


def test_batchnorm_bf16_takes_statistics_in_f32():
    """A bf16 input is normalised with f32 statistics, as flax does, and
    comes back bf16; gradients reach the f32 scale and bias."""
    bn = BatchNorm(4).train()
    x = (torch.randn(8, 4, 5, 5) * 3 + 1).bfloat16().requires_grad_(True)
    y = bn(x)
    assert y.dtype == torch.bfloat16
    assert bn.pending[0].dtype == torch.float32
    ref = torch.nn.functional.batch_norm(x.float(), None, None,
                                         training=True, eps=1e-5)
    assert (y.float() - ref).abs().max() < 0.03  # one bf16 ulp at 4
    y.float().sum().backward()
    assert bn.weight.grad.dtype == torch.float32 and x.grad is not None


def test_bf16_body_near_jax_bf16():
    """bf16 body on the same weights: logits within 0.1 of the JAX bf16
    module's (values of size ~1, five normalised bf16 layers)."""
    mod, variables = _jax_d(seed=7, dtype=jnp.bfloat16)
    x = _images(seed=8)
    want = mod.apply(variables, jnp.asarray(x), train=True,
                     mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = _port_d(variables, torch.bfloat16)(torch.from_numpy(x),
                                                 train=True)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() < 0.1


def test_conv_block_4x4_stride2_pads_like_explicit_pad():
    """k=4, stride 2: zero padding of (k-1)//2 = 1 on each side, so an
    even input halves exactly."""
    blk = ConvBlock(3, 5, 4, stride=2, norm_type="batch", act_type=None)
    assert blk(torch.zeros(2, 3, 16, 16)).shape == (2, 5, 8, 8)


@pytest.mark.parametrize("cfg", [{"type": "patchgan"}, {"type": "multiscale"},
                                 {"type": "pixelgan"},
                                 {"type": "adiscriminator"}])
def test_define_d_refuses_what_is_not_ported(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        define_D({"network_D": cfg})


def test_define_d_reads_the_size_from_the_name():
    net = define_D({"network_D": {"type": "discriminator_vgg_128",
                                  "base_nf": 4}}, dtype=torch.float32)
    assert net.n_blocks == 5 and net.linear0.in_features == 64 * 4 * 4
