"""Every trainer option of the JAX ``SRTrainer`` through the port's
``SRTrainer`` on the CPU, against the JAX package's, from one carried
state and the same batches, the port fed the random draws the JAX step
makes from its key (``jax_step_draws``: the batch augmentation's choice
and quantities, DiffAugment's for each stage). Each option that the port
refused before (ROADMAP Queue A 10.8-10.11) builds a trainer and takes two
steps here; the three-step checks of each option are in
``test_torch_options_steps.py`` and the modules' own files.

Logs within 1e-4 relative (floor 1e-3; D_real and D_fake, logits near 0,
against 0.3), as ``test_torch_train_step.py`` holds the slice's step; with
an adaptive rule (adam, rmsprop, adamp, ranger, madgrad) 2e-3 from the
second step on, where an element whose gradient is rounding has moved a
whole learning rate the other way.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_batchaug import jax_batchaug_draws
from test_torch_diffaug import jax_draws as jax_da_draws
from test_torch_train_step import _numpy, _redraw
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)

BATCH, LR_PX = 4, 8
ADAPTIVE = ("adam", "rmsprop", "adamp", "ranger", "madgrad")


def options(optim="sgd", lr=1e-2, crop=32, **train):
    """A small GAN configuration (G nf 16, nb 1, gc 16; D-VGG base_nf 8
    with batch norms), f32 pixel and GAN losses, with ``train`` on top."""
    return {
        "is_train": True, "scale": 4,
        "network_G": {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 16,
                      "upscale": 4, "gaussian_noise": False},
        "network_D": {"type": "discriminator_vgg", "size": crop,
                      "base_nf": 8},
        "train": {
            "lr_G": lr, "lr_D": lr, "optim_G": optim, "optim_D": optim,
            "pixel_criterion": "l1", "pixel_weight": 1e-2,
            "gan_type": "vanilla", "gan_weight": 5e-3,
            "lr_scheme": "MultiStepLR", "lr_steps": [50000], **train},
    }


def batches(n=3, batch=BATCH, lr_px=LR_PX, seed=0):
    rng = np.random.RandomState(seed)
    return [{"LR": rng.rand(batch, lr_px, lr_px, 3).astype(np.float32),
             "HR": rng.rand(batch, lr_px * 4, lr_px * 4, 3).astype(
                 np.float32)} for _ in range(n)]


def jax_step_draws(jt, key, shapes) -> dict:
    """The draws of the JAX step whose state key is ``key``, for the
    shapes the port's step asks for (``SRTrainer._draw_shapes``)."""
    _, r_aug, r_da, _, _ = jax.random.split(key, 5)
    out = {}
    if "aug" in shapes:
        out["aug"] = jax_batchaug_draws(jt.batchaug, r_aug, shapes["aug"])
    for stage in ("da_g", "da_d"):
        if stage in shapes:
            out[stage] = jax_da_draws(r_da, jt.dapolicy, shapes[stage])
    return out


def carried(jstate) -> dict:
    """Everything of a JAX state the port's loads: both nets with their
    optimizer states, SWA, the LocNet, the clip history."""
    d = jstate.d
    return train_state_from_jax(
        _numpy(jstate.g.params), None if d is None else _numpy(d.params),
        None if d is None else _numpy(d.extra.get("batch_stats", {})),
        int(jstate.step), g_opt_state=_numpy(jstate.g.opt_state),
        d_opt_state=None if d is None else _numpy(d.opt_state),
        swa_params=None if jstate.swa_params is None
        else _numpy(jstate.swa_params),
        swa_n=None if jstate.swa_n is None else np.asarray(jstate.swa_n),
        loc=None if jstate.loc is None else serialization.to_state_dict(
            _numpy(jstate.loc)),
        grad_hist=None if jstate.grad_hist is None
        else _numpy(jstate.grad_hist))


def pair(opt, batch=BATCH, lr_px=LR_PX):
    """The JAX trainer and state (weights redrawn from numpy seeds; a
    LocNet's fc3 too, so that its maps move the target) and the port's
    trainer with the state loaded from it, its draws taken from the JAX
    state's key."""
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (batch, lr_px, lr_px, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)))
    if jstate.d is not None:
        jstate = jstate.replace(
            d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    if jstate.loc is not None:
        lp = _numpy(jstate.loc.params)
        rng = np.random.RandomState(5)
        lp["fc3"] = {k: (rng.randn(*v.shape) * 0.01).astype(np.float32)
                     for k, v in lp["fc3"].items()}
        jstate = jstate.replace(loc=jstate.loc.replace(
            params=lp, opt_state=jt.optG.init(lp)))
    if jstate.swa_params is not None:
        jstate = jstate.replace(swa_params=jstate.g.params)
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, carried(jstate))
    return jt, jstate, pt, pstate


def close(logs, jlogs, rel, step):
    assert set(logs) == set(jlogs), (step, sorted(logs), sorted(jlogs))
    for k in jlogs:
        got, want = float(logs[k]), float(jlogs[k])
        assert np.isfinite(got), (step, k)
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        assert abs(got - want) <= rel * max(abs(want), floor), \
            (step, k, got, want)


def run(opt, n_steps, batch=BATCH, lr_px=LR_PX, seed=0, optim=None):
    """``n_steps`` steps of both trainers on seeded batches, the port on
    JAX's draws; every step's logs held by ``close``. Returns (jt, jstate,
    pt, pstate)."""
    jt, jstate, pt, pstate = pair(opt, batch, lr_px)
    optim = optim or opt["train"]["optim_G"]
    for step, b in enumerate(batches(n_steps, batch, lr_px, seed)):
        key = jstate.rng
        pt.draw_hook = lambda shapes, key=key: jax_step_draws(jt, key,
                                                              shapes)
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
        rel = 2e-3 if step and optim in ADAPTIVE else 1e-4
        close(logs, jlogs, rel, step)
    assert pstate.step == int(jstate.step) == n_steps
    return jt, jstate, pt, pstate


# the options each refused before with its ROADMAP item, now each taking
# two steps against the JAX package (a virtual batch of 2 microbatches:
# A is the count of microbatches, which must divide the batch)
REFUSED = [
    ("train", "mixup", True), ("train", "diffaug", True),
    ("train", "fs", True), ("train", "lr_scheme", "CosineAnnealingLR"),
    ("opt", "use_atg", True), ("train", "freeze_loc", 2),
    ("opt", "use_swa", True), ("train", "freeze_d", True),
    ("train", "grad_clip", "auto"), ("train", "virtual_batch_size", 2),
    ("train", "optim_G", "ranger"), ("train", "lr_scheme", "StepLR"),
    ("train", "optim_D", "madgrad"), ("train", "lr_scheme",
                                      "ReduceLROnPlateau"),
]


@pytest.mark.parametrize("where,key,value", REFUSED)
def test_each_option_steps_against_jax(where, key, value):
    """Each option on the small configuration: two steps within the
    tolerances above (AdaTarget on from step 0 at a 28-px crop, a multiple
    of its 7-px grid; SWA from step 0; DiffAugment with the yml's policy;
    ``freeze_d`` alone freezes nothing, as in the JAX package)."""
    crop = 28 if key == "use_atg" else 32
    opt = options(crop=crop)
    if key == "diffaug":
        opt["train"]["dapolicy"] = "color,translation,cutout"
    if key == "lr_scheme":
        opt["train"].update(T_max=4, lr_step_size=1, lr_gamma=0.5)
    (opt if where == "opt" else opt["train"])[key] = value
    jt, _, pt, _ = run(opt, 2, lr_px=crop // 4,
                       optim="ranger" if value == "ranger" else "sgd")
    if key == "lr_scheme":
        # past the two steps taken: the schedule over T_max and its
        # boundaries, held to the JAX trainer's
        for step in range(6):
            assert pt.schedG.get_lr(step) == jt.schedG.get_lr(step), step
        if value == "ReduceLROnPlateau":
            assert pt.schedG.get_lr(5) == 1e-2
    if key == "freeze_d":
        assert pt.freeze_loc == 0
