"""The deinterlacer against the JAX package on the CPU: ``DVDNet``,
``vertical_upscale`` and ``replace_field`` (``models/dvd.py``) within
1e-5, ``interlace``, ``DVDDataset`` and the synthetic ``dvd`` kind equal
to JAX's, and three ``DVDTrainer`` steps (nf 8, b 2, 32 px, sgd at lr
1e-2, pixel L1; with and without a PatchGAN D of ndf 8) from one carried
state: logs within 1e-4 relative, every tensor within 1e-3 of its update
(``test_torch_pix2pix_trainer.check_tensors``).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.data import datasets as jds
from trainner_tpu.data import video_datasets as jvd
from trainner_tpu.models import dvd as jdvd
from trainner_tpu.train.dvd_trainer import DVDTrainer as JaxTrainer
from trainner_tpu_torch.data import datasets as pds
from trainner_tpu_torch.data import video_datasets as pvd
from trainner_tpu_torch.data.common import save_img
from trainner_tpu_torch.models import dvd as pdvd
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.dvd_trainer import DVDTrainer
from trainner_tpu_torch.utils.torch_interop import (g_from_jax,
                                                    load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)
BATCH, PX, STEPS, NF = 2, 32, 3, 8


def options(gan: bool = False, **train):
    opt = {"name": "dvd_steps", "model": "dvd", "scale": 1,
           "datasets": {"train": {"name": "t", "mode": "dvd",
                                  "dataroot_HR": "/x", "crop_size": PX,
                                  "batch_size": BATCH}},
           "network_G": {"type": "dvd_net", "nf": NF},
           "path": {"root": "/tmp/dvd_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50], **train}}
    if gan:
        opt["network_D"] = {"type": "patchgan", "ndf": 8, "n_layers": 2}
        opt["train"].update(gan_type="lsgan", gan_weight=0.1)
    return dict(parse_dict(opt, is_train=True))


def dvd_batch(seed=0):
    rng = np.random.RandomState(seed)
    top = rng.rand(BATCH, PX, PX, 3).astype(np.float32)
    bottom = rng.rand(BATCH, PX, PX, 3).astype(np.float32)
    x = top.copy()
    x[:, 1::2] = bottom[:, 1::2]
    return {"in": x, "top": top, "bottom": bottom}


def _jax_net(x):
    net = jdvd.DVDNet(nf=NF)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return net, _redraw(params, 3, 1.0)


def test_dvd_net_and_fields_match_jax():
    """The net from the JAX parameters, and both field helpers, within
    1e-5 of the JAX ones on a seeded batch."""
    x = dvd_batch(1)["in"]
    jnet, params = _jax_net(x)
    want_t, want_b = jnet.apply({"params": params}, jnp.asarray(x))
    net = pdvd.DVDNet(nf=NF)
    net.load_state_dict(g_from_jax(params, None, net))
    got_t, got_b = net(torch.from_numpy(x))
    for g, w in ((got_t, want_t), (got_b, want_b)):
        assert g.shape == (BATCH, PX, PX, 3)
        assert np.abs(g.detach().numpy() - np.asarray(w)).max() < 1e-5
    # the kept fields come from the input exactly
    assert np.array_equal(got_t.detach().numpy()[:, 0::2], x[:, 0::2])
    assert np.array_equal(got_b.detach().numpy()[:, 1::2], x[:, 1::2])
    half = np.random.RandomState(2).rand(BATCH, PX // 2, PX, 3).astype(
        np.float32)
    for up in (True, False):
        np.testing.assert_allclose(
            pdvd.vertical_upscale(torch.from_numpy(half), up).numpy(),
            np.asarray(jdvd.vertical_upscale(jnp.asarray(half), up)),
            atol=1e-5)
        np.testing.assert_allclose(
            pdvd.replace_field(torch.from_numpy(half), torch.from_numpy(x),
                               up).numpy(),
            np.asarray(jdvd.replace_field(jnp.asarray(half), jnp.asarray(x),
                                          up)), atol=1e-5)


def _frames(root, n=3, hw=(37, 29), seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        save_img((rng.rand(*hw, 3) * 255).astype(np.uint8),
                 os.path.join(root, f"{i:03d}.png"))
    return root


def test_interlace_and_datasets_match_jax(tmp_path):
    """``interlace`` and the test phase of ``DVDDataset`` equal the JAX
    ones sample by sample (whole frames cut to an even height); a training
    sample is a crop of the pair at an even row; the synthetic ``dvd``
    kind is JAX's; the modes ``dvd`` and ``dvdi`` build ``DVDDataset``;
    a set that names only ``dataroot_LR`` raises in both packages."""
    rng = np.random.RandomState(3)
    a, b = (rng.rand(6, 5, 3).astype(np.float32) for _ in range(2))
    assert np.array_equal(pvd.interlace(a, b), jvd.interlace(a, b))
    root = _frames(str(tmp_path / "frames"))
    opt = {"dataroot_HR": root, "phase": "test", "crop_size": 16}
    got, want = pvd.DVDDataset(opt), jvd.DVDDataset(opt)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        assert g["in"].shape == (36, 29, 3)
        for k in ("in", "top", "bottom"):
            assert np.array_equal(g[k], w[k])
    train = pvd.DVDDataset({**opt, "phase": "train"})
    frames = want[0]
    for _ in range(4):
        s = train[0]
        assert s["in"].shape == (16, 16, 3)
        hits = [(y, x) for y in range(0, 36 - 15, 2)
                for x in range(0, 29 - 15)
                if np.array_equal(frames["top"][y:y + 16, x:x + 16],
                                  s["top"])]
        assert hits and np.array_equal(
            pvd.interlace(s["top"], s["bottom"]), s["in"])
    syn = {"mode": "synthetic", "kind": "dvd", "crop_size": 8}
    for i in range(2):
        g, w = pds.create_dataset(syn)[i], jds.create_dataset(syn)[i]
        for k in ("in", "top", "bottom"):
            assert np.array_equal(g[k], w[k])
    for mode in ("dvd", "dvdi"):
        assert isinstance(pds.create_dataset({**opt, "mode": mode}),
                          pvd.DVDDataset)
    for cls in (pvd.DVDDataset, jvd.DVDDataset):
        with pytest.raises(ValueError, match="dataroot_HR"):
            cls({"dataroot_LR": root, "phase": "test"})


def _carried(jstate, pstate):
    d = jstate.d
    return train_state_from_jax(
        _numpy(jstate.g.params), None if d is None else _numpy(d.params),
        None if d is None else _numpy(d.extra.get("batch_stats")),
        int(jstate.step), g_opt_state=_numpy(jstate.g.opt_state),
        d_opt_state=None if d is None else _numpy(d.opt_state),
        g_net=pstate.g.net, d_net=None if d is None else pstate.d.net)


def _nets(pstate):
    out = {f"g.{k}": v for k, v in sd(pstate.g.net).items()}
    if pstate.d is not None:
        out.update({f"d.{k}": v for k, v in sd(pstate.d.net).items()})
    return out


@pytest.mark.parametrize("gan", [False, True], ids=["g", "g_and_d"])
def test_three_steps_match_jax(gan):
    """Each step of the port from the JAX state of that step: the logs
    (``_T`` / ``_B``, the GAN's, D's) within 1e-4 relative and every
    tensor within 1e-3 of its update; ``eval_step`` is the top frame and
    ``eval_step_both`` both, as JAX's."""
    opt = options(gan)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (BATCH, PX, PX, 3))
    jstate = jstate.replace(g=jstate.g.replace(
        params=_redraw(jstate.g.params, 1, 1.0)))
    if gan:
        jstate = jstate.replace(d=jstate.d.replace(
            params=_redraw(jstate.d.params, 2, 1.0)))
    pt = DVDTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    assert (pstate.d is not None) == gan
    for step in range(STEPS):
        batch = dvd_batch(step)
        load_train_state(pstate, _carried(jstate, pstate))
        before = _nets(pstate)
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = _carried(jstate, pstate)
        want = {**{f"g.{k}": v.numpy() for k, v in want["g"].items()},
                **{f"d.{k}": v.numpy() for k, v in want.get("d",
                                                            {}).items()}}
        assert {"l_g_pix_T", "l_g_pix_B", "l_g_total"} <= set(logs)
        _check_logs({k: float(v) for k, v in logs.items()},
                    {k: float(v) for k, v in jlogs.items()}, 1e-4, step)
        check_tensors(_nets(pstate), want, before, step, "all")
    x = dvd_batch(9)["in"]
    wt, wb = jt.eval_step_both(jstate, jnp.asarray(x))
    load_train_state(pstate, _carried(jstate, pstate))
    gt, gb = pt.eval_step_both(pstate, torch.from_numpy(x))
    assert np.abs(gt.numpy() - np.asarray(wt)).max() < 1e-5
    assert np.abs(gb.numpy() - np.asarray(wb)).max() < 1e-5
    assert torch.equal(pt.eval_step(pstate, torch.from_numpy(x)), gt)


@pytest.mark.parametrize("sr_option", [
    {"use_ema": True}, {"use_swa": True}, {"use_atg": True},
    {"use_unshuffle": True, "unshuffle_scale": 2}, {"use_cem": True}])
def test_the_sr_step_options_stay_with_the_sr_trainer(sr_option):
    """The DVD trainer extends the shared ``Trainer``, not the ``sr`` one:
    the ``sr`` step's own options (EMA, SWA, AdaTarget, unshuffle, CEM),
    which the JAX DVD trainer never reads, are not read here either. The
    state holds no EMA, SWA or LocNet, G reads its input as given, and a
    step runs."""
    tr = DVDTrainer({**options(), **sr_option}, device="cpu")
    st = tr.init_state(0)
    assert st.ema is None and st.swa is None and st.loc is None
    assert tr.unshuffle_scale == 0 and not tr.use_cem
    st, logs = tr.train_step(st, {k: torch.from_numpy(v)
                                  for k, v in dvd_batch(2).items()})
    assert st.step == 1 and np.isfinite(float(logs["l_g_total"]))
