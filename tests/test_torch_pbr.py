"""The PBR material trainer and dataset against the JAX package on the
CPU: ``_find_maps`` and ``PBRDataset`` in the test phase equal to JAX's
(the modes ``pbr`` and ``lrhrpbr``); three ``PBRTrainer`` steps
(``rrdb_net`` nf 8, nb 2, gc 4, latent noise off, ROADMAP C 9; scale 4,
b 2, HR 32 px; sgd at lr 1e-2; pixel L1 and a VGG19 feature L1 on seeded
weights) over two three-channel maps (diffuse, normal) and two
one-channel maps (height, roughness) from one carried state: logs within
1e-4 relative, every tensor within 1e-3 of its update
(``test_torch_pix2pix_trainer.check_tensors``); the one-channel stack has
no feature loss.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loss_stack import _vgg19_npz
from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.data import pbr_dataset as jpbr
from trainner_tpu.train.pbr_trainer import PBRTrainer as JaxTrainer
from trainner_tpu_torch.data import datasets as pds
from trainner_tpu_torch.data import pbr_dataset as ppbr
from trainner_tpu_torch.data.common import save_img
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.pbr_trainer import PBRTrainer
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)
BATCH, HR, STEPS = 2, 32, 3
MAPS = {"diffuse": 3, "normal": 3, "height": 1, "roughness": 1}


def options(vgg, model="pbr", **train):
    opt = {"name": "pbr_steps", "model": model, "scale": 4,
           "datasets": {"train": {"name": "t", "mode": "pbr",
                                  "dataroot_HR": "/x", "crop_size": HR,
                                  "batch_size": BATCH}},
           "network_G": {"type": "rrdb_net", "nf": 8, "nb": 2, "gc": 4,
                         "gaussian_noise": False},
           "path": {"root": "/tmp/pbr_steps", "vgg_weights": vgg},
           "train": {"lr_G": 1e-2, "optim_G": "sgd",
                     "lr_scheme": "MultiStepLR", "lr_steps": [50],
                     "pixel_criterion": "l1", "pixel_weight": 1.0,
                     "feature_criterion": "l1", "feature_weight": 1.0,
                     **train}}
    return dict(parse_dict(opt, is_train=True))


def pbr_batch(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, nc in MAPS.items():
        out[f"HR_{name}"] = rng.rand(BATCH, HR, HR, nc).astype(np.float32)
        out[f"LR_{name}"] = rng.rand(BATCH, HR // 4, HR // 4, nc).astype(
            np.float32)
    out["LR"], out["HR"] = out["LR_diffuse"], out["HR_diffuse"]
    return out


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    return _vgg19_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")


def write_materials(root, n=2, px=(40, 36), seed=0):
    """``n`` material folders: diffuse and normal PNGs, a height map as a
    grey PNG, a glossiness map, and a second diffuse-like ``_color`` file
    that loses to ``_diffuse`` by name."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        d = os.path.join(root, f"mat{i}")
        os.makedirs(d, exist_ok=True)
        for name in ("m_diffuse", "m_normal", "z_color", "m_gloss"):
            save_img((rng.rand(*px, 3) * 255).astype(np.uint8),
                     os.path.join(d, f"{name}.png"))
        save_img((rng.rand(*px, 1) * 255).astype(np.uint8),
                 os.path.join(d, "m_Height.png"))
    return root


def test_find_maps_and_dataset_match_jax(tmp_path):
    root = write_materials(str(tmp_path / "mats"))
    d0 = os.path.join(root, "mat0")
    assert ppbr._find_maps(d0) == jpbr._find_maps(d0)
    assert set(ppbr._find_maps(d0)) == {"diffuse", "normal", "height",
                                        "roughness"}
    opt = {"dataroot_HR": root, "dataroot_LR": "/ignored", "phase": "test",
           "scale": 4, "crop_size": 64}
    for mode in ("pbr", "lrhrpbr"):
        got = pds.create_dataset({**opt, "mode": mode})
        assert isinstance(got, ppbr.PBRDataset)
    want = jpbr.PBRDataset(opt)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        assert g["HR_height"].shape == (36, 36, 1)
        assert g["LR_diffuse"].shape == (9, 9, 3)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(g[k], v, atol=1e-6)
            else:
                assert g[k] == v
    train = ppbr.PBRDataset({**opt, "phase": "train", "crop_size": 16})
    s = train[1]
    assert s["HR_roughness"].shape == (16, 16, 1)
    assert s["LR"].shape == (4, 4, 3)


def _carried(jstate, pstate):
    return train_state_from_jax(
        _numpy(jstate.g.params), step=int(jstate.step),
        g_opt_state=_numpy(jstate.g.opt_state), g_net=pstate.g.net)


def test_three_steps_match_jax(vgg, model="pbr"):
    """Each step of the port from the JAX state of that step: the logs of
    every map and ``l_g_total`` within 1e-4 relative, every tensor within
    1e-3 of its update; the one-channel maps log no feature loss;
    ``eval_step`` serves G as JAX's."""
    opt = options(vgg, model)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0),
                           (BATCH, HR // 4, HR // 4, 3))
    jstate = jstate.replace(g=jstate.g.replace(
        params=_redraw(jstate.g.params, 1, 1.0)))
    pt = PBRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    assert pstate.d is None
    assert not any(e.tag == "fea" for e in pt.loss_1ch.entries)
    for step in range(STEPS):
        batch = pbr_batch(step)
        load_train_state(pstate, _carried(jstate, pstate))
        before = {f"g.{k}": v for k, v in sd(pstate.g.net).items()}
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert {"l_g_fea_diffuse", "l_g_fea_normal", "l_g_pix_height",
                "l_g_pix_roughness"} <= set(logs)
        assert "l_g_fea_height" not in logs
        _check_logs({k: float(v) for k, v in logs.items()},
                    {k: float(v) for k, v in jlogs.items()}, 1e-4, step)
        want = {f"g.{k}": v.numpy()
                for k, v in _carried(jstate, pstate)["g"].items()}
        check_tensors({f"g.{k}": v for k, v in sd(pstate.g.net).items()},
                      want, before, step, "g")
    x = pbr_batch(9)["LR"]
    load_train_state(pstate, _carried(jstate, pstate))
    want = np.asarray(jt.eval_step(jstate, jnp.asarray(x)))
    got = pt.eval_step(pstate, torch.from_numpy(x), "g").numpy()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("model", ["sr_pbr", "pbr_sr"])
def test_the_aliases_build_the_pbr_trainer(vgg, model):
    """``sr_pbr`` and ``pbr_sr`` build ``PBRTrainer``, as the JAX
    ``train.py`` does, and step."""
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    pt = create_trainer({**options(vgg, model), "use_amp": False},
                        device="cpu")
    assert isinstance(pt, PBRTrainer)
    st, logs = pt.train_step(pt.init_state(0), {
        k: torch.from_numpy(v) for k, v in pbr_batch(1).items()})
    assert st.step == 1 and np.isfinite(float(logs["l_g_total"]))


def test_one_noise_draw_for_every_map(vgg):
    """With the latent noise on, every map's G pass of a step reads one
    draw: two maps with equal inputs give equal outputs in a step, as one
    JAX key gives them; the next step draws anew."""
    opt = options(vgg)
    opt["network_G"]["gaussian_noise"] = True
    pt = PBRTrainer(opt, dtype=torch.float32, device="cpu")
    st = pt.init_state(0)
    seen = []
    orig = pt._g

    def spy(net, x):
        out = orig(net, x)
        seen.append(out.detach().clone())
        return out

    pt._g = spy
    b = pbr_batch(0)
    b["LR_normal"] = b["LR_diffuse"].copy()
    for _ in range(2):
        st, _ = pt.train_step(st, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    assert torch.equal(seen[0], seen[2])  # diffuse and normal, one draw
    assert not torch.equal(seen[0], seen[4])
    assert all(m.held is None for m in st.g.net.modules()
               if hasattr(m, "held"))


def test_a_held_noise_draw_serves_one_shape_and_type():
    """A held draw is reused by passes of its shape and type and refuses
    any other, so a pass that would need a fresh draw fails instead of
    breaking the one draw of a step."""
    from trainner_tpu_torch.ops.blocks import GaussianNoise

    noise = GaussianNoise(0.1).train()
    noise.generator = torch.Generator().manual_seed(0)
    noise.hold = True
    x = torch.ones(1, 4, 4, 8)
    first = noise(x)
    assert torch.equal(noise(x), first)
    for other in (torch.ones(1, 4, 4, 4), x.double()):
        with pytest.raises(ValueError, match="held latent-noise draw"):
            noise(other)
    noise.hold, noise.held = False, None
    assert not torch.equal(noise(x), first)
