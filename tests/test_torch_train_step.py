"""The training slice as a whole: ``SRTrainer.train_step`` of the port
(``trainner_tpu_torch/train/sr_trainer.py``) against the JAX package's, from
identical carried state and the same batch, on the CPU: every log entry,
G's and D's parameters, D's running statistics and the step counter, over
three consecutive steps with ``D_update_ratio: 2`` (steps with and without
a G update); one bf16 step; gradient clipping. The tests that need no JAX
side are in ``test_torch_trainer.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu_torch.train.sr_trainer import SRTrainer, clip_grads
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax,
                                                    vgg_from_jax)

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)

BATCH, LR_PX = 4, 8


def _opt(optim="adam", lr=1e-4, ratio=2, **train):
    return {
        "is_train": True, "scale": 4,
        "network_G": {"type": "rrdb_net", "nf": 32, "nb": 2, "gc": 32,
                      "upscale": 4, "gaussian_noise": False},
        "network_D": {"type": "discriminator_vgg", "size": 32, "base_nf": 8},
        "train": {
            "lr_G": lr, "lr_D": lr, "optim_G": optim, "optim_D": optim,
            "pixel_criterion": "l1", "pixel_weight": 1e-2,
            "feature_criterion": "l1", "feature_weight": 1.0,
            "gan_type": "vanilla", "gan_weight": 5e-3,
            "lr_scheme": "MultiStepLR", "lr_steps": [50000],
            "D_update_ratio": ratio, **train},
    }


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _redraw(params, seed, gain):
    """Conv and dense kernels at ``gain / sqrt(fan_in)`` and small non-zero
    biases from a numpy seed: the default init (Kaiming x 0.1, zero biases)
    leaves G's output near 1e-4 and the block's c_k at zero biases."""
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


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"LR": rng.rand(BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(BATCH, LR_PX * 4, LR_PX * 4, 3).astype(np.float32)}


def _pair(opt, jdt, tdt):
    """The two trainers on one state: the JAX state with redrawn weights,
    the port's loaded from it, the JAX side's random VGG carried across."""
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jdt)
    jstate = jt.init_state(jax.random.PRNGKey(0), (BATCH, LR_PX, LR_PX, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)),
        d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    pt = SRTrainer(copy.deepcopy(opt), dtype=tdt, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, _carried(jstate))
    vgg = _numpy(jt.generator_loss.entries[1].fn.variables["params"])
    pt.generator_loss.entries[1].fn.model.load_state_dict(
        vgg_from_jax(vgg), strict=False)
    return jt, jstate, pt, pstate


def _carried(jstate, moments=False):
    opt = {"g_opt_state": _numpy(jstate.g.opt_state),
           "d_opt_state": _numpy(jstate.d.opt_state)} if moments else {}
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step), **opt)


def _port_tensors(pstate):
    return {"g": {k: v.detach().numpy().copy()
                  for k, v in pstate.g.net.state_dict().items()},
            "d": {k: v.detach().numpy().copy()
                  for k, v in pstate.d.net.state_dict().items()}}


def _jax_tensors(jstate):
    c = _carried(jstate)
    return {w: {k: v.numpy() for k, v in c[w].items()} for w in ("g", "d")}


def _check_logs(logs, jlogs, rel, step):
    assert set(logs) == set(jlogs), step
    for k in jlogs:
        got, want = float(logs[k]), float(jlogs[k])
        assert np.isfinite(got), (step, k)
        # D_real / D_fake are means of logits of size ~0.3 that lie near 0
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        assert abs(got - want) <= rel * max(abs(want), floor), \
            (step, k, got, want)


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_three_train_steps_match_jax(optim):
    """f32, noise off, D_update_ratio 2: step 0 updates G and D, step 1
    only D (G runs forward without gradients), step 2 both again, each
    from the state the step before left. A second port state is loaded
    from the JAX state after step 0, optimizer moments included, and takes
    steps 1 and 2 beside the first: a carried-over run continues alike.

    Logs: relative 1e-4 (f32 sums in another order through G, VGG19 and D);
    with adam 2e-3 from the second step on, after a few elements whose
    gradient is rounding have moved by lr the other way.
    D's running statistics: 1e-5 relative to their size (adam: 1e-3, a
    conv bias that moved by lr the other way shifts the batch mean by as
    much). Parameters:
    * sgd at lr 1e-2, where new - old = -lr * (g + 0.9 * trace) shows every
      gradient linearly: each tensor within 1e-3 of its own largest update
      (plus 2e-7, a rounding of the parameter);
    * adam at lr 1e-4, whose first steps are about lr * sign(g), so an
      element whose gradient is near zero may move a whole lr the other
      way: every element within 2 lr per step taken, and all but 0.1 % of
      each tensor's elements within 0.02 lr per step taken.
    Some of D's gradients are zero but for rounding, so nothing holds them
    beyond a bound on the noise (sgd: 1e-6; adam: the 2 lr per step): the
    biases of the convs that a batch norm follows (the norm removes any
    shift), and the biases of the two dense layers (the relativistic loss
    does not change when every logit shifts, and most hidden units keep
    one LeakyReLU slope over the whole batch)."""
    lr = 1e-2 if optim == "sgd" else 1e-4
    jt, jstate, pt, pstate = _pair(_opt(optim, lr), jnp.float32,
                                   torch.float32)
    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    resumed = None
    g_updates = 0
    for step in range(3):
        old, port_old = _jax_tensors(jstate), _port_tensors(pstate)
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(pstate, tbatch)
        assert ("l_g_total" in logs) == (step % 2 == 0)
        g_updates += step % 2 == 0
        _check_logs(logs, jlogs,
                    2e-3 if optim == "adam" and step else 1e-4, step)
        assert pstate.step == int(jstate.step) == step + 1
        new = _jax_tensors(jstate)

        def compare(got, g_steps, d_steps):
            for which in ("g", "d"):
                assert set(got[which]) == set(new[which])
                n_steps = g_steps if which == "g" else d_steps
                for k, want in new[which].items():
                    err = np.abs(got[which][k] - want)
                    if "running_" in k:
                        rel = 1e-5 if optim == "sgd" else 1e-3
                        assert err.max() <= rel * np.abs(want).max(), \
                            (step, k)
                        assert not np.array_equal(want, old[which][k]), k
                        continue
                    noise_only = which == "d" and k.endswith("bias") and (
                        k.startswith("linear")
                        or k.replace("bias", "norm.weight") in new[which])
                    if optim == "sgd":
                        moved = np.abs(want - old[which][k]).max()
                        tol = 1e-6 if noise_only else 1e-3 * moved + 2e-7
                        assert err.max() <= tol, \
                            (step, which, k, err.max(), moved)
                    else:
                        assert err.max() <= 2 * lr * max(n_steps, 1), \
                            (step, which, k)
                        far = (err > 0.02 * lr * n_steps).mean()
                        assert noise_only or far <= 1e-3, \
                            (step, which, k, far)

        got = _port_tensors(pstate)
        compare(got, g_updates, step + 1)
        if step == 0:
            # a second port state takes the JAX state after step 0 with
            # its optimizer moments and continues beside the first
            resumed = pt.init_state(9)
            load_train_state(resumed, _carried(jstate, moments=True))
            assert resumed.step == 1
            assert resumed.g.opt.count == (optim == "adam")
        else:
            resumed, _ = pt.train_step(resumed, tbatch)
            compare(_port_tensors(resumed), g_updates - 1, step)
        if step == 1:  # no G update: G's parameters did not move
            for k, want in new["g"].items():
                np.testing.assert_array_equal(want, old["g"][k])
                np.testing.assert_array_equal(got["g"][k], port_old["g"][k])


def test_bf16_step_logs_near_jax():
    """One bf16 step (bodies of G, D and VGG in bf16, losses f32) on the
    same f32 state: every log within 5 % of the JAX bf16 step's (the two
    round at other places through 6 blocks, VGG19 and D), all finite."""
    jt, jstate, pt, pstate = _pair(_opt("adam", ratio=1), jnp.bfloat16,
                                   torch.bfloat16)
    batch = _batch(1)
    jstate, jlogs = jt.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstate, logs = pt.train_step(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "D_real" in logs and "l_g_gan" in logs
    for k in ("D_real", "D_fake"):  # logit means near 0: absolute
        assert abs(float(logs.pop(k)) - float(jlogs.pop(k))) < 0.05
    _check_logs(logs, jlogs, 5e-2, 0)
    for p in pstate.g.net.parameters():
        assert p.dtype == torch.float32


@pytest.mark.parametrize("mode,value", [("norm", 0.05), ("value", 1e-3)])
def test_clip_grads_matches_jax(mode, value):
    from trainner_tpu.train.sr_trainer import clip_grads as jax_clip

    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    want = jax_clip([jnp.asarray(g) for g in grads], mode, value)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_grads(params, mode, value)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)
