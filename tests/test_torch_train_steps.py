"""The k-step window of the port, ``SRTrainer.train_steps`` and
``can_scan_steps`` (``trainner_tpu_torch/train/sr_trainer.py``), against k
``train_step`` calls of the port and against the JAX package's
``train_steps`` (one ``lax.scan`` dispatch), at the debug widths (G nf 16,
nb 2, gc 8; D-VGG base_nf 16; batch 4, 16 -> 64 px) on the CPU. Also
``Scheduler.get_lrs``, which hands the window its learning rates.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.train import schedulers as jax_sched
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu_torch.train.schedulers import build_scheduler
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax,
                                                    vgg_from_jax)

torch.set_num_threads(2)

K, BATCH, LR_PX = 3, 4, 16


def _opt(optim="sgd", lr=1e-2, ratio=1, noise=False, **train):
    return {
        "is_train": True, "scale": 4,
        "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8,
                      "upscale": 4, "gaussian_noise": noise},
        "network_D": {"type": "discriminator_vgg", "size": 64,
                      "base_nf": 16},
        "train": {
            "lr_G": lr, "lr_D": lr, "optim_G": optim, "optim_D": optim,
            "pixel_criterion": "l1", "pixel_weight": 1e-2,
            "feature_criterion": "l1", "feature_weight": 1.0,
            "gan_type": "vanilla", "gan_weight": 5e-3,
            # a MultiStep boundary inside the window: steps 1 and 2 run
            # at lr / 2
            "lr_scheme": "MultiStepLR", "lr_steps": [1], "lr_gamma": 0.5,
            "D_update_ratio": ratio, **train},
    }


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _redraw(params, seed, gain):
    """Kernels at ``gain / sqrt(fan_in)`` and small biases from a numpy
    seed, so that G's output is of size ~1 (as test_torch_train_step)."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return (rng.randn(*v.shape) * gain / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (0.8 + 0.4 * rng.rand(*v.shape)).astype(np.float32)
        return (rng.randn(*v.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _numpy(params))


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    return {"LR": rng.rand(K, BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(K, BATCH, LR_PX * 4, LR_PX * 4, 3).astype(
                np.float32)}


def _pair(opt):
    """The JAX trainer and state with redrawn weights, and the port's
    trainer and state loaded from it (the JAX side's random VGG too)."""
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (BATCH, LR_PX, LR_PX, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)),
        d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step)))
    vgg = _numpy(jt.generator_loss.entries[1].fn.variables["params"])
    pt.generator_loss.entries[1].fn.model.load_state_dict(
        vgg_from_jax(vgg), strict=False)
    return jt, jstate, pt, pstate


def _port_tensors(pstate):
    return {w: {k: v.detach().numpy().copy()
                for k, v in getattr(pstate, w).net.state_dict().items()}
            for w in ("g", "d")}


def _jax_tensors(jstate):
    c = train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step))
    return {w: {k: v.numpy() for k, v in c[w].items()} for w in ("g", "d")}


def _tbatches(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def test_train_steps_equals_k_train_step_calls_bit_for_bit():
    """One seed, two port trainers: a window of three steps (latent noise
    on, drawn from the state's generator) against three ``train_step``
    calls. The window runs the same program, so the logs, every parameter
    and statistic, the optimizer moments and the step counter are equal
    bit for bit."""
    opt = _opt("adam", 1e-4, noise=True)
    batches = _tbatches(_batches())
    a = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    b = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    assert a.can_scan_steps()
    sa, sb = a.init_state(3), b.init_state(3)
    sa, window = a.train_steps(sa, batches)
    seq = []
    for i in range(K):
        sb, logs = b.train_step(sb, {k: v[i] for k, v in batches.items()})
        seq.append(logs)
    assert sa.step == sb.step == K
    assert set(window) == set(seq[0])
    for k, v in window.items():
        assert v.shape == (K,) and v.dtype == torch.float32
        assert torch.equal(v, torch.stack([lg[k] for lg in seq])), k
    for w in ("g", "d"):
        na, nb = getattr(sa, w), getattr(sb, w)
        for (name, ta), tb in zip(na.net.state_dict().items(),
                                  nb.net.state_dict().values()):
            assert torch.equal(ta, tb), (w, name)
        for ma, mb in zip(na.opt.mu + na.opt.nu, nb.opt.mu + nb.opt.nu):
            assert torch.equal(ma, mb)
        assert int(na.opt.count) == int(nb.opt.count) == K


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_train_steps_matches_jax(optim):
    """The port's window against the JAX ``train_steps`` (one scan) from
    the same carried state and batches, f32, noise off, with the MultiStep
    boundary after the first step. Logs: sgd within 1e-4 relative; adam
    within 1e-4 at the first step and 2e-3 after it (the step tolerances
    of test_torch_train_step.py: a few elements whose gradient is rounding
    move by lr the other way). Parameters after the window: adam as there,
    every element within 2 lr per step and all but 0.1 % within 0.02 lr
    per step; sgd (lr 1e-2, where a parameter's move shows its gradients
    linearly) each tensor within 2e-2 of its own largest move plus 2e-7,
    1e-6 for the biases that only rounding moves. test_torch_train_step.py
    holds sgd to 1e-3 of the move at nf 32 and D base_nf 8 on 32 px with G
    updated at two of three steps; here D's fake logits move by about 1
    per step, and the third step's GAN gradient carries D's rounding into
    G's HR-side convs at up to 1.4 % of their move (both packages' own
    rounding; with the GAN term at 1e-9 the gap stays at one rounding)."""
    lr = 1e-2 if optim == "sgd" else 1e-4
    opt = _opt(optim, lr)
    jt, jstate, pt, pstate = _pair(opt)
    assert jt.can_scan_steps() and pt.can_scan_steps()
    batches = _batches()
    old = _jax_tensors(jstate)
    jstate, jlogs = jt.train_steps(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    pstate, logs = pt.train_steps(pstate, _tbatches(batches))
    assert pstate.step == int(jstate.step) == K
    assert set(logs) == set(jlogs)
    for k, want in jlogs.items():
        want = np.asarray(want)
        got = logs[k].numpy()
        assert got.shape == want.shape == (K,)
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        for i in range(K):
            rel = 2e-3 if optim == "adam" and i else 1e-4
            assert abs(got[i] - want[i]) <= rel * max(abs(want[i]), floor), \
                (k, i, got[i], want[i])
    new, got = _jax_tensors(jstate), _port_tensors(pstate)
    for which in ("g", "d"):
        for k, want in new[which].items():
            err = np.abs(got[which][k] - want)
            if "running_" in k:
                rel = 1e-5 if optim == "sgd" else 1e-3
                assert err.max() <= rel * np.abs(want).max(), k
                continue
            noise_only = which == "d" and k.endswith("bias") and (
                k.startswith("linear")
                or k.replace("bias", "norm.weight") in new[which])
            if optim == "sgd":
                moved = np.abs(want - old[which][k]).max()
                tol = 1e-6 if noise_only else 2e-2 * moved + 2e-7
                assert err.max() <= tol, (which, k, err.max(), moved)
            else:
                assert err.max() <= 2 * lr * K, (which, k)
                far = (err > 0.02 * lr * K).mean()
                assert noise_only or far <= 1e-3, (which, k, far)


def test_window_learning_rates_cross_the_boundary():
    """The window's learning rates are the schedule's at each step: with
    sgd and zero momentum the parameter update of step i is -lr_i * g_i,
    so a window whose boundary is ignored would move G by twice as much
    at steps 1 and 2. Checked through the optimizer's calls."""
    opt = _opt("sgd", 1e-2)
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    state = pt.init_state(0)
    seen = []
    step = state.g.opt.step
    state.g.opt.step = lambda lr: (seen.append(float(lr)), step(lr))
    pt.train_steps(state, _tbatches(_batches()))
    assert seen == [np.float32(x) for x in (1e-2, 5e-3, 5e-3)]
    assert seen == [np.float32(x) for x in pt.schedG.get_lrs(0, K)]


def test_fallback_stacks_the_key_union_with_nan_as_jax():
    """D_update_ratio 2: G is updated at steps 0 and 2 only, so the window
    is no single program: both packages fall back to k ``train_step``
    calls and stack each log over the union of keys, NaN at step 1 for
    the G-stage entries. Adam at the debug options' lr 1e-4; the values
    agree within test_torch_train_step.py's adam tolerances: 1e-4
    relative at the first step,
    2e-3 after it."""
    opt = _opt("adam", 1e-4, ratio=2)
    jt, jstate, pt, pstate = _pair(opt)
    assert not jt.can_scan_steps() and not pt.can_scan_steps()
    batches = _batches(1)
    jstate, jlogs = jt.train_steps(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    pstate, logs = pt.train_steps(pstate, _tbatches(batches))
    assert pstate.step == int(jstate.step) == K
    assert set(logs) == set(jlogs)
    assert "l_g_total" in logs
    for k, want in jlogs.items():
        want = np.asarray(want)
        got = logs[k].numpy()
        assert got.shape == want.shape == (K,)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        for i in np.flatnonzero(~np.isnan(want)):
            rel = 2e-3 if i else 1e-4
            assert abs(got[i] - want[i]) <= rel * max(abs(want[i]), floor), \
                (k, i, got[i], want[i])
    assert np.isnan(logs["l_g_total"][1]) and not np.isnan(
        logs["l_g_total"][0])
    assert not np.isnan(logs["l_d_total"].numpy()).any()


@pytest.mark.parametrize("train_opt,step0", [
    ({"lr_steps": [1], "lr_gamma": 0.5}, 0),
    ({"lr_steps": [10, 20, 40], "lr_gamma": 0.1, "lr_G": 3e-4}, 8),
    ({"lr_scheme": "multistep", "lr_steps": [5], "warmup_iters": 8}, 2),
])
def test_get_lrs_is_get_lr_of_each_step(train_opt, step0):
    got = build_scheduler(dict(train_opt), base_lr=None)
    want = jax_sched.build_scheduler(dict(train_opt), base_lr=None)
    assert got.get_lrs(step0, 10) == [got.get_lr(step0 + i)
                                      for i in range(10)]
    assert got.get_lrs(step0, 10) == [want.get_lr(step0 + i)
                                      for i in range(10)]


def test_graphs_are_the_card_default_and_refused_on_the_cpu():
    """``graphs`` is a Python argument: None means on for ``cuda`` and off
    for the CPU; asked for on the CPU it raises (a graph is captured on
    the card only), for the trainer and for the degradation step alike."""
    from test_torch_pipeline import _bsrgan_opt
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.train import create_trainer, make_otf_degradation
    from trainner_tpu_torch.train.producer import EagerDegradation

    opt = _opt()
    assert SRTrainer(copy.deepcopy(opt), device="cpu").graphs is False
    assert create_trainer(copy.deepcopy(opt), device="cpu",
                          graphs=False).graphs is False
    with pytest.raises(ValueError, match="cuda"):
        create_trainer(copy.deepcopy(opt), device="cpu", graphs=True)
    popt = parse_dict(_bsrgan_opt(), is_train=True)
    assert isinstance(make_otf_degradation(popt, "cpu"), EagerDegradation)
    with pytest.raises(ValueError, match="cuda"):
        make_otf_degradation(popt, "cpu", graphs=True)
