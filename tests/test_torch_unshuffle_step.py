"""Training steps of this slice's generator options against the JAX
trainer on the CPU, from one carried state and the same batches: the
pixel-unshuffled ``mrrdb_net`` (Real-ESRGAN's x2 layout, narrow), an
``sr_resnet`` with batch norms in the NAC order (its running statistics
from the step's one G pass), and ``use_cem`` in the G stage (box and
cubic); three steps each with ``D_update_ratio: 2``, at the tolerances of
``test_torch_train_step.py`` (sgd at lr 1e-2: logs within 1e-4 relative,
every tensor within 1e-3 of its own largest update plus 2e-7, running
statistics within 1e-5 of their size). Then a checkpoint of the BN G's
state, with G's ``batch_stats``, both ways with the JAX package's files.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_train_step import _check_logs, _numpy
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (g_from_jax,
                                                    load_train_state,
                                                    train_state_from_jax,
                                                    train_state_to_jax,
                                                    vgg_from_jax)

torch.set_num_threads(2)
BATCH, LR_PX, LR = 4, 8, 1e-2


def _options(scale, network_G, d_size, **top):
    opt = {"name": "unshuffle_step", "model": "sr", "scale": scale,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x",
                                  "crop_size": d_size, "batch_size": BATCH}},
           "network_G": network_G,
           "network_D": {"type": "discriminator_vgg", "nf": 8},
           "path": {"root": "/tmp/unshuffle_step"},
           "train": {"lr_G": LR, "lr_D": LR, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1e-2, "feature_criterion": "l1",
                     "feature_weight": 1.0, "gan_type": "vanilla",
                     "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50000], "D_update_ratio": 2}}
    opt.update(top)
    return dict(parse_dict(opt, is_train=True))


CONFIGS = {
    "mrrdb-unshuffle": lambda: _options(
        2, {"type": "mrrdb_net", "scale": 4, "nf": 16, "nb": 1, "gc": 8},
        16, use_unshuffle=True),
    "srresnet-bn-nac": lambda: _options(
        4, {"type": "sr_resnet", "nf": 16, "nb": 2, "norm_type": "batch",
            "mode": "NAC", "act_type": "prelu"}, 32),
    "cem-box": lambda: _options(
        4, {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 8,
            "gaussian_noise": False}, 32, use_cem=True),
    "cem-cubic": lambda: _options(
        4, {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 8,
            "gaussian_noise": False}, 32, use_cem=True,
        cem={"kernel": "cubic"}),
}


def _redraw(params, seed, gain):
    """Kernels at ``gain / sqrt(fan_in)``, norm scales near 1, PReLU
    slopes near 0.25, small biases, from a numpy seed (as
    ``test_torch_train_step._redraw``, with 0-d leaves)."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            out = rng.randn(*v.shape) * gain / np.sqrt(np.prod(v.shape[:-1]))
        elif name == "scale":
            out = 0.8 + 0.4 * rng.rand(*v.shape)
        elif name == "negative_slope":
            out = 0.25 + 0.05 * rng.randn()
        else:
            out = rng.randn(*v.shape) * 0.02
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _numpy(params))


def _batch(scale, seed=0):
    rng = np.random.RandomState(seed)
    return {"LR": rng.rand(BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(BATCH, LR_PX * scale, LR_PX * scale,
                           3).astype(np.float32)}


def _carried(jstate, net):
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step), g_net=net,
        g_batch_stats=_numpy(jstate.g.extra.get("batch_stats")))


def _pair(opt):
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    scale = opt["scale"]
    jstate = jt.init_state(jax.random.PRNGKey(0), (BATCH, LR_PX, LR_PX, 3),
                           (BATCH, LR_PX * scale, LR_PX * scale, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)),
        d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, _carried(jstate, pstate.g.net))
    vgg = _numpy(jt.generator_loss.entries[1].fn.variables["params"])
    pt.generator_loss.entries[1].fn.model.load_state_dict(
        vgg_from_jax(vgg), strict=False)
    return jt, jstate, pt, pstate


def _tensors(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_jax(name):
    opt = CONFIGS[name]()
    jt, jstate, pt, pstate = _pair(opt)
    assert pt.unshuffle_scale == (2 if "unshuffle" in name else 0)
    assert pt.use_cem == ("cem" in name)
    net = pstate.g.net
    batch = _batch(opt["scale"])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(3):
        old = {"g": _tensors(net.state_dict()),
               "d": _tensors(pstate.d.net.state_dict())}
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(pstate, tbatch)
        _check_logs(logs, jlogs, 1e-4, step)
        carried = _carried(jstate, net)
        for which, got_sd in (("g", net.state_dict()),
                              ("d", pstate.d.net.state_dict())):
            got = _tensors(got_sd)
            want = {k: v.numpy() for k, v in carried[which].items()}
            assert set(got) == set(want)
            for k, w in want.items():
                err = np.abs(got[k] - w).max()
                if "running_" in k:
                    assert err <= 1e-5 * np.abs(w).max(), (step, which, k)
                    assert not np.array_equal(w, old[which][k]), k
                    continue
                moved = np.abs(w - old[which][k]).max()
                noise_only = which == "d" and k.endswith("bias") and (
                    k.startswith("linear")
                    or k.replace("bias", "norm.weight") in want)
                tol = 1e-6 if noise_only else 1e-3 * moved + 2e-7
                assert err <= tol, (step, which, k, err, moved)
    assert pstate.step == 3


def test_eval_step_unshuffles_and_projects_as_jax():
    """``eval_step`` of the unshuffled mrrdb_net with CEM (cubic) and
    without (``apply_cem=False``) against the JAX ``_eval_step``."""
    opt = CONFIGS["mrrdb-unshuffle"]()
    opt["use_cem"] = True
    opt["cem"] = {"kernel": "cubic"}
    jt, jstate, pt, pstate = _pair(opt)
    lr = np.random.RandomState(3).rand(2, 10, 12, 3).astype(np.float32)
    for apply_cem in (None, False):
        want = jt.eval_step(jstate, jnp.asarray(lr), apply_cem=apply_cem)
        got = pt.eval_step(pstate, torch.from_numpy(lr),
                           apply_cem=apply_cem)
        assert got.shape == (2, 20, 24, 3)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("shape,tiles", [
    # tiles of 16 at a stride of 12: rows 0, 12, 24, columns 0, 12, 24, 36
    ((1, 40, 52, 3), 12),
    # the last row of tiles pinned at an odd offset (25), two images
    ((2, 41, 30, 3), 12),
])
def test_chop_unshuffles_each_tile_as_jax(shape, tiles):
    """``eval_step_chop`` of the unshuffled mrrdb_net on an LR of several
    tiles (patch 16, overlap 4): each tile is unshuffled on its own, so a
    tile pinned to the edge at an odd offset still divides by the
    unshuffle scale; against the JAX ``eval_step_chop``, f32 within
    1e-5."""
    opt = CONFIGS["mrrdb-unshuffle"]()
    jt, jstate, pt, pstate = _pair(opt)
    lr = np.random.RandomState(4).rand(*shape).astype(np.float32)
    seen = []
    eval_step = pt.eval_step

    def spy(state, t):
        seen.append(tuple(t.shape))
        return eval_step(state, t)

    pt.eval_step = spy
    got = pt.eval_step_chop(pstate, torch.from_numpy(lr), 16, 4).numpy()
    want = np.asarray(jt.eval_step_chop(jstate, jnp.asarray(lr), 16, 4))
    b, h, w, _ = shape
    assert seen == [(tiles * b, 16, 16, 3)]
    assert got.shape == want.shape == (b, 2 * h, 2 * w, 3)
    assert np.abs(got - want).max() < 1e-5


def test_g_batch_stats_checkpoint_both_ways(tmp_path):
    """The BN G's state after a step: the port's ``.state`` tree is the
    JAX tree (G's ``extra/batch_stats`` included) and loads in the JAX
    package with equal values; a JAX ``.state`` loads in the port with
    G's running statistics exactly."""
    opt = CONFIGS["srresnet-bn-nac"]()
    jt, jstate, pt, pstate = _pair(opt)
    batch = _batch(4)
    pstate, _ = pt.train_step(pstate, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    tree = train_state_to_jax(pstate)
    assert tree["g"]["extra"]["batch_stats"]
    path = str(tmp_path / "1.state")
    C.save_state(pstate, path)
    loaded, _ = JC.load_state(path, jstate)
    for got, want in ((loaded.g.extra["batch_stats"],
                       tree["g"]["extra"]["batch_stats"]),
                      (loaded.g.params, tree["g"]["params"])):
        for (kp, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(_numpy(got)),
                jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(g, w, err_msg=str(kp))

    jstate, _ = jt.train_step(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    jpath = str(tmp_path / "j.state")
    JC.save_state(jstate, jpath)
    fresh_t = SRTrainer(copy.deepcopy(opt), dtype=torch.float32,
                        device="cpu")
    fresh, meta = C.load_state(jpath, fresh_t.init_state(5))
    assert meta["iter"] == 1
    want = g_from_jax(_numpy(jstate.g.params),
                      _numpy(jstate.g.extra["batch_stats"]), fresh.g.net)
    got = fresh.g.net.state_dict()
    assert any("running_mean" in k for k in want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # the JAX state tree and the port's have the same leaves
    want_keys = set(serialization.to_state_dict(jstate)["g"]["extra"]
                    ["batch_stats"])
    assert want_keys == set(train_state_to_jax(fresh)["g"]["extra"]
                            ["batch_stats"])
