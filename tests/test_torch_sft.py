"""SFTGAN's networks (``trainner_tpu_torch/models/sft.py``) against the JAX
package's on the CPU: ``SFTNet`` at nf 8 with 2 blocks (cond_nf 32, and
16, where the SFT layers keep their hidden width of 32: ROADMAP C 22) on
a 16 px LR with 64 px maps, and the ACD discriminator at its only size,
96 px, b=2, in eval and train mode. The same flax weights (the init with
each leaf scaled by a draw near 1, from a numpy seed) go into both: every
output in f32 within 1e-5; the weights go to flax and back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2i_nets import _variables, check_net
from trainner_tpu.models import sft as JS
from trainner_tpu_torch.models import sft as PS
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.utils.torch_interop import net_from_jax

torch.set_num_threads(2)


def _lr_seg(seed=0, px=16):
    rng = np.random.RandomState(seed)
    seg = rng.rand(2, 4 * px, 4 * px, 8).astype(np.float32)
    return (rng.rand(2, px, px, 3).astype(np.float32),
            seg / seg.sum(-1, keepdims=True))


@pytest.mark.parametrize("cond_nf", [32, 16])
def test_sftnet_matches_jax(cond_nf):
    lr, seg = _lr_seg()
    jm = JS.SFTNet(nf=8, cond_nf=cond_nf, n_blocks=2)
    pm = PS.SFTNet(nf=8, cond_nf=cond_nf, n_blocks=2)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(lr), jnp.asarray(seg),
                                         train=False))
    rng = np.random.RandomState(1)
    v = jax.tree.map(lambda a: (a * (1 + 0.3 * rng.randn(*a.shape)) + (
        0.02 * rng.randn(*a.shape) if a.ndim == 1 else 0)).astype(
            np.float32), v)
    sd = net_from_jax(v["params"], None, pm)
    pm.load_state_dict(sd, strict=True)
    assert pm.sft_final.scale0.weight.shape[:2] == (32, cond_nf)
    want = np.asarray(jm.apply(v, jnp.asarray(lr), jnp.asarray(seg),
                               train=False))
    got = pm(torch.from_numpy(lr), torch.from_numpy(seg))
    assert got.shape == (2, 64, 64, 3)
    assert np.abs(got.detach().numpy() - want).max() < 1e-5
    from trainner_tpu_torch.utils.torch_interop import net_to_jax

    back = net_to_jax(pm.state_dict(), pm)[0]
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back),
        jax.tree_util.tree_leaves(v["params"])))


def test_sftnet_condition_is_a_stride4_valid_conv_at_lr_size():
    """cond0 reads the HR-size maps with a 4x4 stride-4 VALID conv: the
    condition sits at the LR size, and a map of another size fails."""
    pm = PS.SFTNet(nf=8, n_blocks=1)
    lr, seg = _lr_seg(px=12)
    assert pm(torch.from_numpy(lr), torch.from_numpy(seg)).shape == \
        (2, 48, 48, 3)
    with pytest.raises(RuntimeError):
        pm(torch.from_numpy(lr), torch.from_numpy(seg[:, :40, :40]))


def test_define_g_builds_sftnet_at_its_defaults():
    net = define_G({"network_G": {"type": "sft_arch", "nf": 8}})
    assert isinstance(net, PS.SFTNet) and net.n_blocks == 16
    assert net.conv0.weight.shape[0] == 64


def test_acd_discriminator_matches_jax():
    """(gan, cls) of the ACD D, in eval and train mode; its batch norms
    are ``BatchNorm_0`` .. ``BatchNorm_6`` in call order, its dense heads
    read the (H, W, C) flattening of the 6 x 6 x 512 map."""
    x = np.random.RandomState(3).rand(2, 96, 96, 3).astype(np.float32)
    pm = PS.ACDVGGBN96()
    assert [n for n, _ in pm.named_children() if n.startswith("Batch")] \
        == [f"BatchNorm_{k}" for k in range(7)]
    check_net(JS.ACDVGGBN96(), pm, x)


def test_acd_takes_96_px_only():
    pm = PS.ACDVGGBN96()
    with pytest.raises(RuntimeError):
        pm(torch.rand(2, 64, 64, 3), train=False)


def test_acd_weights_round_trip_with_statistics():
    x = np.random.RandomState(4).rand(2, 96, 96, 3).astype(np.float32)
    v = _variables(JS.ACDVGGBN96(), x)
    pm = PS.ACDVGGBN96()
    sd = net_from_jax(v["params"], v["batch_stats"], pm)
    pm.load_state_dict(sd, strict=True)
    assert torch.equal(pm.BatchNorm_3.running_var, torch.from_numpy(
        v["batch_stats"]["BatchNorm_3"]["var"]))
