"""The video SR trainer (``trainner_tpu_torch/train/vsr_trainer.py``)
against the JAX ``VSRTrainer`` on the CPU, from one carried state: SOF-VSR
at ``channels`` 32 with its RRDB tail at nf 16, nb 1, gc 8 (latent noise
off in both: ROADMAP C 9), clips of 3 frames at 16 px LR, b=2, x4, the
pixel loss with the OFR term at its three levels (``ofr_weight`` 0.1,
``ofr_wl1`` 0.1, ``ofr_wl2`` 0.2), SGD at 1e-2 (Adam's first step moves
an element by its gradient's sign, which rounding flips where the
gradient is near 0); and ``vsrgan`` with SRnet's tail,
a PatchGAN D and a vanilla GAN. Three steps each, each from the JAX state
of that step: every log within 1e-4 relative, every G and D tensor within
1e-3 of its largest update plus 2e-7
(``test_torch_pix2pix_trainer.check_tensors``). Beside them: ``tv_sum``,
``ofr_loss`` and the OFR term's half-size resize against JAX,
and ``eval_step`` and ``eval_step_chop`` against the JAX ones (both CLIs:
``test_torch_video_cli.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.models.sofvsr import SOFVSR as JaxSOFVSR
from trainner_tpu.train import vsr_trainer as JV
from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C
from trainner_tpu_torch.ops.imresize import jax_resize
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train import vsr_trainer as PV
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)
B, T, LR, S, STEPS = 2, 3, 16, 4, 3
G_CFG = {"type": "sofvsr_net", "n_frames": T, "channels": 32,
         "SR_net": "rrdb", "sr_nf": 16, "sr_nb": 1}


def options(gan: bool = False, **train):
    g = dict(G_CFG, SR_net="sofvsr") if gan else dict(G_CFG)
    opt = {"name": "vsr_steps", "model": "vsrgan" if gan else "vsr",
           "scale": S,
           "datasets": {"train": {"name": "t", "mode": "video",
                                  "dataroot_HR": "/x", "crop_size": LR * S,
                                  "batch_size": B, "num_frames": T}},
           "network_G": g,
           "path": {"root": "/tmp/vsr_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "ofr_weight": 0.1,
                     "ofr_wl1": 0.1, "ofr_wl2": 0.2,
                     "lr_scheme": "CosineAnnealingLR_Restart", "niter": 100,
                     **train}}
    if gan:
        opt["network_D"] = {"type": "patchgan", "ndf": 8, "n_layers": 2}
        opt["train"].update(gan_type="vanilla", gan_weight=5e-2)
    return dict(parse_dict(opt, is_train=True))


def clip_batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    hr = rng.rand(B, T, LR * S, LR * S, 3).astype(np.float32)
    # a shifted copy of one frame in each, so that the flows have work
    hr[:, 0] = np.roll(hr[:, 1], 2, axis=2)
    lr = hr.reshape(B, T, LR, S, LR, S, 3).mean((3, 5))
    return {"LR": lr.astype(np.float32), "HR": hr}


def _quiet(jt, pnet):
    """Latent noise off on both sides (ROADMAP C 9)."""
    m = jt.netG
    jt.netG = JaxSOFVSR(scale=m.scale, n_frames=m.n_frames,
                        channels=m.channels, img_ch=m.img_ch,
                        sr_net=m.sr_net, sr_nf=m.sr_nf, sr_nb=m.sr_nb,
                        sr_gaussian_noise=False, dtype=m.dtype)
    for blk in pnet.modules():
        if isinstance(blk, ResidualDenseBlock5C):
            blk.noise = None


def carried(jstate, pstate):
    gan = jstate.d is not None
    return train_state_from_jax(
        _numpy(jstate.g.params),
        _numpy(jstate.d.params) if gan else None,
        _numpy(jstate.d.extra.get("batch_stats")) if gan else None,
        int(jstate.step), g_opt_state=_numpy(jstate.g.opt_state),
        d_opt_state=_numpy(jstate.d.opt_state) if gan else None,
        g_net=pstate.g.net, d_net=pstate.d.net if gan else None)


def _start(opt):
    jt = JV.VSRTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    pt = PV.VSRTrainer(copy.deepcopy(opt), dtype=torch.float32,
                       device="cpu")
    pstate = pt.init_state(0)
    _quiet(jt, pstate.g.net)
    b0 = clip_batch(0)
    template = jt.init_state(jax.random.PRNGKey(0), b0["LR"].shape,
                             b0["HR"].shape)
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 1.0)))
    if jstate.d is not None:
        jstate = jstate.replace(d=jstate.d.replace(
            params=_redraw(template.d.params, 2, 1.0)))
    load_train_state(pstate, carried(jstate, pstate))
    return jt, jstate, pt, pstate


@pytest.fixture(scope="module", params=["ofr", "vsrgan"])
def run(request):
    opt = options(gan=request.param == "vsrgan")
    jt, jstate, pt, pstate = _start(opt)
    steps = []
    nets = ("g", "d") if jstate.d is not None else ("g",)
    for step in range(STEPS):
        batch = clip_batch(step)
        load_train_state(pstate, carried(jstate, pstate))
        before = {w: sd(getattr(pstate, w).net) for w in nets}
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = carried(jstate, pstate)
        steps.append({"logs": {k: float(v) for k, v in logs.items()},
                      "jlogs": {k: float(v) for k, v in jlogs.items()},
                      "before": before,
                      "after": {w: sd(getattr(pstate, w).net) for w in nets},
                      "want": {w: {k: v.numpy() for k, v in want[w].items()}
                               for w in nets}})
    return {"steps": steps, "nets": nets, "jt": jt, "jstate": jstate,
            "pt": pt, "pstate": pstate, "case": request.param}


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_jax(run, step):
    rec = run["steps"][step]
    _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)
    assert "ofr" in rec["logs"]
    if run["case"] == "vsrgan":
        assert {"l_g_gan", "l_d_total"} <= set(rec["logs"])
    for w in run["nets"]:
        check_tensors(rec["after"][w], rec["want"][w], rec["before"][w],
                      step, w)


def test_eval_step_and_chop_match_jax(run):
    """The served SR frame, plain and chopped into quadrants (a min_size
    of 20 splits a 24 px clip once into quadrants of 20 px), from the
    state after the steps."""
    jt, pt = run["jt"], run["pt"]
    load_train_state(run["pstate"], carried(run["jstate"], run["pstate"]))
    x = np.random.RandomState(7).rand(1, T, 24, 24, 3).astype(np.float32)
    want = np.asarray(jt.eval_step(run["jstate"], jnp.asarray(x)))
    got = pt.eval_step(run["pstate"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    want = np.asarray(jt.eval_step_chop(run["jstate"], jnp.asarray(x), 20))
    got = pt.eval_step_chop(run["pstate"], torch.from_numpy(x), 20).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    with pytest.raises(NotImplementedError, match="x8"):
        pt.eval_step_x8(run["pstate"], torch.from_numpy(x))


def test_tv_and_ofr_loss_match_jax():
    rng = np.random.RandomState(3)
    x0, x1 = (rng.rand(2, 12, 10, 3).astype(np.float32) for _ in range(2))
    flow = (rng.randn(2, 12, 10, 2) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(PV.tv_sum(torch.from_numpy(flow))),
        float(JV.tv_sum(jnp.asarray(flow))), rtol=1e-6)
    np.testing.assert_allclose(
        float(PV.ofr_loss(*map(torch.from_numpy, (x0, x1, flow)), 0.3)),
        float(JV.ofr_loss(*map(jnp.asarray, (x0, x1, flow)), 0.3)),
        rtol=1e-6)


def test_half_size_resize_is_jax_linear():
    """The OFR term's half-size level: jax.image.resize 'linear', which
    antialiases on a downscale (F.interpolate does not)."""
    x = np.random.RandomState(4).rand(2, 16, 12, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 8, 6, 3),
                                       "linear"))
    got = jax_resize(torch.from_numpy(x), (8, 6), "linear",
                     antialias=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(8, 6),
        mode="bilinear").permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 1e-3
