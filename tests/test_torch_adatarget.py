"""AdaTarget of the port (``trainner_tpu_torch/ops/adatarget.py``,
``ops/warp.py``) against the JAX package's on the CPU: ``grid_sample``
with border and zeros padding, ``align_corners`` either way, and its
gradients, within 1e-5; the patch extraction, centring and folding bit for
bit; ``ada_target`` with a carried LocNet within 1e-5 and the LocNet's
gradients through it; then the trainer: three steps across
``atg_start_iter``, AdaTarget ignoring the virtual batch, and the refusal
of a region that a D of fixed input size cannot take (ROADMAP C 19).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer_options import carried, options, run
from trainner_tpu.ops import adatarget as ja
from trainner_tpu.ops import warp as jw
from trainner_tpu_torch.ops import adatarget as pa
from trainner_tpu_torch.ops import warp as pw
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import loc_from_jax, loc_to_jax

torch.set_num_threads(2)


def _rand(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).rand(*shape) * scale
            + shift).astype(np.float32)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample_matches_jax(align, padding):
    """A 3 x 9 x 11 x 2 image sampled at a grid reaching 30 % past the
    edges: the output and the gradients of a weighted sum with respect to
    the image and the grid within 1e-5 of JAX's."""
    img = _rand(3, 9, 11, 2)
    grid = _rand(3, 5, 6, 2, seed=1, scale=2.6, shift=-1.3)
    wts = _rand(3, 5, 6, 2, seed=2)

    def jfn(i, g):
        return jnp.sum(jw.grid_sample(i, g, align, padding) * wts)

    want = np.asarray(jw.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                     align, padding))
    gi, gg = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(img),
                                          jnp.asarray(grid))
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    got = pw.grid_sample(ti, tg, align, padding)
    (got * torch.from_numpy(wts)).sum().backward()
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    assert np.abs(ti.grad.numpy() - np.asarray(gi)).max() <= 1e-5
    # the grid's gradient jumps where a coordinate crosses a pixel; none
    # of these lands on one
    assert np.abs(tg.grad.numpy() - np.asarray(gg)).max() <= 1e-4


@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (1, 30, 33, 3),
                                   (2, 128, 128, 1)])
def test_patches_match_jax_bit_for_bit(shape):
    """``extract_patches``, ``center_patches`` (one unfold per axis where
    JAX loops over the grid) and ``fold_patches`` equal JAX's; folding the
    extracted patches gives the region the grid covers."""
    x = _rand(*shape, seed=3)
    for po, pt in ((7, 9), (5, 9)):
        ep = np.asarray(ja._extract_patches(jnp.asarray(x), po))
        cp = np.asarray(ja._center_patches(jnp.asarray(x), pt, po))
        got_e = pa.extract_patches(torch.from_numpy(x), po)
        assert np.array_equal(got_e.numpy(), ep)
        assert np.array_equal(pa.center_patches(torch.from_numpy(x), pt,
                                                po).numpy(), cp)
        b, h, w, c = shape
        folded = pa.fold_patches(got_e, b, h, w, c, po).numpy()
        assert np.array_equal(folded, np.asarray(ja._fold_patches(
            jnp.asarray(ep), b, h, w, c, po)))
        assert np.array_equal(folded, x[:, :h // po * po, :w // po * po])


def _loc_pair(seed=4):
    net = ja.LocNet()
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 7, 7)),
                 jnp.zeros((1, 9, 9)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + (rng.randn(*a.shape)
                                                     * 0.05).astype(
        np.float32), flax.core.unfreeze(v["params"]))
    port = pa.LocNet()
    port.load_state_dict(loc_from_jax(params))
    return net, params, port


def test_loc_net_matches_jax_and_starts_at_the_identity():
    """The LocNet's maps within 1e-6 of JAX's for carried weights; its
    flax names and shapes round-trip; a fresh one (fc3 zero) gives the
    identity map."""
    net, params, port = _loc_pair()
    out, tgt = _rand(50, 7, 7, seed=5), _rand(50, 9, 9, seed=6)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(out),
                                jnp.asarray(tgt)))
    got = port(torch.from_numpy(out), torch.from_numpy(tgt))
    assert np.abs(got.detach().numpy() - want).max() <= 1e-6
    back = loc_to_jax(port.state_dict())
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    fresh = pa.LocNet()
    fresh.init_weights(torch.Generator().manual_seed(0))
    eye = fresh(torch.from_numpy(out), torch.from_numpy(tgt))
    assert torch.equal(eye, torch.tensor(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(50, 2, 3))


@pytest.mark.parametrize("hw", [(28, 28), (30, 33)])
def test_ada_target_matches_jax(hw):
    """``ada_target`` on a 2-sample output and target (the 7-px grid's
    ragged edge cut at 30 x 33): the aligned target within 1e-5 of JAX's,
    and the gradients of a weighted sum with respect to the LocNet's
    parameters within 1e-5 of each tensor's largest."""
    net, params, port = _loc_pair(7)
    out = _rand(2, *hw, 3, seed=8)
    tgt = _rand(2, *hw, 3, seed=9)
    wts = _rand(2, hw[0] // 7 * 7, hw[1] // 7 * 7, 3, seed=10)

    def jfn(p):
        return jnp.sum(ja.ada_target(jnp.asarray(out), jnp.asarray(tgt), p,
                                     net) * wts)

    want = np.asarray(ja.ada_target(jnp.asarray(out), jnp.asarray(tgt),
                                    params, net))
    wgrads = loc_from_jax(jax.tree.map(np.asarray, jax.grad(jfn)(params)))
    got = pa.ada_target(torch.from_numpy(out), torch.from_numpy(tgt), port)
    (got * torch.from_numpy(wts)).sum().backward()
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    for name, p in port.named_parameters():
        ref = wgrads[name].numpy()
        assert np.abs(p.grad.numpy() - ref).max() <= \
            1e-5 * np.abs(ref).max() + 1e-9, name


def test_atg_steps_match_jax_across_its_start():
    """``use_atg`` from step 1 at a 28-px crop: step 0 trains G alone,
    steps 1 and 2 G and the LocNet jointly through the pixel loss (the
    LocNet clipped by norm to ``grad_clip_value``); the logs as the
    options' steps are held, the LocNet's weights within 1e-5 of JAX's."""
    opt = options(crop=28, atg_start_iter=1, grad_clip="norm",
                  grad_clip_value=0.05)
    opt["use_atg"] = True
    _, jstate, pt, pstate = run(opt, 3, lr_px=7)
    want = carried(jstate)["loc"]
    for k, v in pstate.loc.net.state_dict().items():
        assert (v - want[k]).abs().max() <= 1e-5, k
    assert set(pt._step_fns) == {(True, True, False), (True, True, True)}


def test_atg_ragged_region_steps_match_jax():
    """Without a GAN loss the crop need not be a multiple of 7: at 32 px
    the loss reads the 28-px region the grid covers, AdaTarget on from
    step 0; three steps as above."""
    opt = options(crop=32, gan_weight=0)
    opt["train"].pop("gan_type")
    opt["use_atg"] = True
    _, jstate, _, pstate = run(opt, 3)
    want = carried(jstate)["loc"]
    for k, v in pstate.loc.net.state_dict().items():
        assert (v - want[k]).abs().max() <= 1e-5, k


def test_atg_ignores_the_virtual_batch():
    """With AdaTarget on, the G stage takes the whole batch at once, as the
    JAX branch does; the D stage still takes A microbatches."""
    opt = options(crop=28, virtual_batch_size=2)
    opt["use_atg"] = True
    run(opt, 2, lr_px=7)


def test_a_region_a_fixed_size_d_cannot_take_raises():
    """At a 32-px crop the 7-px grid covers 28 px, which D-VGG-32 cannot
    take: the JAX step raises (ScopeParamShapeError), and so does the
    port, naming C 19."""
    opt = options(crop=32)
    opt["use_atg"] = True
    tr = SRTrainer(opt, dtype=torch.float32, device="cpu")
    st = tr.init_state(0)
    batch = {"LR": torch.rand(2, 8, 8, 3), "HR": torch.rand(2, 32, 32, 3)}
    with pytest.raises(NotImplementedError, match="C 19"):
        tr.train_step(st, batch)
