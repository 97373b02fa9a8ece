"""PPON, PAN and A2N (``trainner_tpu_torch/models/ppon.py``, ``pan.py``)
against the JAX package's flax modules on the CPU, at narrow widths: the
same weights (drawn by flax's init, a nonzero self-attention ``gamma``)
moved by ``g_from_jax``, the same seeded input, every output within 1e-5
in f32; ``g_to_jax`` gives the flax tree back bit for bit. PAN at scales
1-4, with ``self_attention``, ``double_scpa`` and each ``ups_inter_mode``;
A2N at scales 2-4 and mode ``m``. Then the align-corners resize alone, and
two ``sr`` training steps of PAN and of A2N against the JAX ``SRTrainer``
(sgd, logs within 1e-4 relative).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.models.networks import define_G as jax_define_G
from trainner_tpu.ops.blocks import \
    bilinear_align_corners as jax_bilinear_align_corners
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.ops.blocks import bilinear_align_corners
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.options.defaults import get_network_G_config
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import (g_from_jax, g_to_jax,
                                                    load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)

CONFIGS = {
    "ppon-x4": ({"type": "ppon", "nf": 8, "nb": 1, "upscale": 4},
                (2, 8, 8, 3)),
    "ppon-x3": ({"type": "ppon", "nf": 8, "nb": 1, "upscale": 3},
                (1, 6, 7, 3)),
    "pan-x1": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 1, "scale": 1},
               (1, 8, 8, 3)),
    "pan-x2": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 2, "scale": 2},
               (2, 8, 8, 3)),
    "pan-x3": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 2, "scale": 3},
               (2, 8, 8, 3)),
    "pan-x4": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 2, "scale": 4},
               (2, 8, 8, 3)),
    "pan-sa-double": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 1,
                       "scale": 4, "self_attention": True,
                       "double_scpa": True}, (2, 8, 12, 3)),
    "pan-bilinear": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 1,
                      "scale": 2, "ups_inter_mode": "bilinear"},
                     (1, 8, 8, 3)),
    "pan-bicubic": ({"type": "pan_net", "nf": 16, "unf": 8, "nb": 1,
                     "scale": 4, "ups_inter_mode": "bicubic"},
                    (1, 8, 8, 3)),
    "a2n-x2": ({"type": "a2n_net", "nf": 16, "unf": 8, "nb": 2, "scale": 2},
               (2, 8, 8, 3)),
    "a2n-x3": ({"type": "a2n_net", "nf": 16, "unf": 8, "nb": 1, "scale": 3},
               (1, 8, 8, 3)),
    "a2n-x4": ({"type": "a2n_net", "nf": 16, "unf": 8, "nb": 2, "scale": 4},
               (2, 8, 8, 3)),
}


def _flax(cfg, shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    net = jax_define_G({"network_G": cfg}, dtype=jnp.float32)
    params = _numpy(net.init({"params": jax.random.PRNGKey(1)},
                             jnp.asarray(x), train=False)["params"])
    if "fsa" in params:
        params["fsa"]["gamma"] = np.float32(0.7)
    return net, params, x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_flax_and_weights_go_back(name):
    cfg, shape = CONFIGS[name]
    jnet, params, x = _flax(cfg, shape)
    want = jnet.apply({"params": params}, jnp.asarray(x), train=False)
    net = define_G({"network_G": cfg})
    net.load_state_dict(g_from_jax(params, None, net))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (3 if cfg["type"] == "ppon" else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = cfg.get("upscale", cfg.get("scale"))
        assert g.shape == w.shape == (shape[0], shape[1] * scale,
                                      shape[2] * scale, 3)
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() < 1e-5
    back, stats = g_to_jax(net.state_dict(), net)
    assert stats == {}
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind, defaults", [
    ("ppon", dict(nf=64, nb=24, upscale=4)),
    ("pan", dict(nf=40, unf=24, nb=16, scale=4, self_attention=False)),
    ("a2n", dict(nf=40, unf=24, nb=16, scale=4, mode="n")),
])
def test_defaults_are_the_jax_packages(kind, defaults):
    from trainner_tpu.options.defaults import \
        get_network_G_config as jax_config

    got = get_network_G_config({"type": kind}, 4)
    assert got == jax_config({"type": kind}, 4)
    for k, v in defaults.items():
        assert got[k] == v, k


@pytest.mark.parametrize("size", [(16, 16), (9, 14), (1, 5)])
def test_align_corners_resize_matches_flax(size):
    x = np.random.default_rng(2).random((2, 4, 7, 3)).astype(np.float32)
    want = np.asarray(jax_bilinear_align_corners(jnp.asarray(x), size=size))
    got = bilinear_align_corners(torch.from_numpy(x), size=size).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6


def _sr_options(network_G):
    opt = {"name": "pan_steps", "model": "sr", "scale": 2,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x", "crop_size": 16,
                                  "batch_size": 2}},
           "network_G": network_G,
           "network_D": {"type": "discriminator_vgg", "nf": 8},
           "path": {"root": "/tmp/pan_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "gan_type": "vanilla",
                     "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50]}}
    return dict(parse_dict(opt, is_train=True))


@pytest.mark.parametrize("network_G", [
    {"type": "pan_net", "nf": 16, "unf": 8, "nb": 1},
    {"type": "a2n_net", "nf": 16, "unf": 8, "nb": 1},
], ids=["pan", "a2n"])
def test_two_sr_steps_match_jax(network_G):
    opt = _sr_options(network_G)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (2, 8, 8, 3),
                           (2, 16, 16, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)),
        d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), 0, g_net=pstate.g.net))
    rng = np.random.RandomState(0)
    batch = {"LR": rng.rand(2, 8, 8, 3).astype(np.float32),
             "HR": rng.rand(2, 16, 16, 3).astype(np.float32)}
    for step in range(2):
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        _check_logs(logs, jlogs, 1e-4, step)
    want = g_from_jax(_numpy(jstate.g.params), None, pstate.g.net)
    for k, v in pstate.g.net.state_dict().items():
        assert np.abs(v.numpy() - want[k].numpy()).max() < 1e-5, k
