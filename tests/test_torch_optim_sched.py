"""The port's optimizers and schedule (``trainner_tpu_torch/train/
optimizers.py``, ``schedulers.py``) against the JAX package's optax chains
and host-side schedules, over several steps on given gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.train import optimizers as jax_opt
from trainner_tpu.train import schedulers as jax_sched
from trainner_tpu_torch.train.optimizers import build_optimizer
from trainner_tpu_torch.train.schedulers import build_scheduler

SHAPES = {"w": (4, 3, 3, 3), "b": (4,), "lin": (5, 7)}
STEPS = 6


def _data(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-8, 1)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(STEPS)]
    lrs = [1e-3 * (0.5 ** (i // 2)) for i in range(STEPS)]
    return params, grads, lrs


def _run_jax(name, params, grads, lrs, **kw):
    opt = jax_opt.build_optimizer(name, **kw)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    out = []
    for g, lr in zip(grads, lrs):
        p, state = opt.apply({k: jnp.asarray(v) for k, v in g.items()},
                             state, p, lr)
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def _run_port(name, params, grads, lrs, **kw):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = build_optimizer(list(tensors.values()), name, **kw)
    out = []
    for g, lr in zip(grads, lrs):
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step(lr)
        out.append({k: t.detach().numpy().copy() for k, t in tensors.items()})
    return out, opt


@pytest.mark.parametrize("name,kw", [
    ("adam", {}),
    ("adam", {"weight_decay": 0.01}),
    ("adam", {"beta1": 0.5, "beta2": 0.9}),
    ("sgd", {}),
    ("sgd", {"weight_decay": 0.01, "momentum": 0.5}),
])
def test_optimizer_trajectory_matches_optax(name, kw):
    """Six steps on given gradients of sizes 1e-8..1 with a changing
    learning rate: parameters within 5e-7 of the optax chain's after every
    step (f32 parameters of size up to 4, one ulp there is 2.4e-7: a
    rounding or two). The weight decay
    is decoupled, as ``add_decayed_weights`` after the scaling is."""
    params, grads, lrs = _data()
    want = _run_jax(name, params, grads, lrs, **kw)
    got, _ = _run_port(name, params, grads, lrs, **kw)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert np.abs(g[k] - w[k]).max() < 5e-7, (step, k)


def test_adam_weight_decay_is_not_l2():
    """torch.optim.Adam's weight_decay adds wd*p to the gradient before
    the moments; the port (and optax) add it after: AdamW's rule."""
    params, grads, lrs = _data(1)
    got, _ = _run_port("adam", params, grads[:1], lrs[:1], weight_decay=0.1)
    p = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
    ref = torch.optim.AdamW([p], lr=lrs[0], weight_decay=0.1, eps=1e-8)
    p.grad = torch.from_numpy(grads[0]["w"].copy())
    ref.step()
    # AdamW decays p by lr*wd*p and then steps; the same to first order
    assert np.abs(got[0]["w"] - p.detach().numpy()).max() < 1e-6


def test_first_adam_step_is_lr_times_sign():
    params, grads, _ = _data(2)
    got, _ = _run_port("adam", params, grads[:1], [1e-2])
    step = got[0]["w"] - params["w"]
    big = np.abs(grads[0]["w"]) > 1e-6
    np.testing.assert_allclose(step[big], -1e-2 * np.sign(grads[0]["w"][big]),
                               rtol=1e-2)


def test_parameter_without_gradient_is_left_alone_and_state_round_trips():
    params, grads, lrs = _data(3)
    tensors = [torch.nn.Parameter(torch.from_numpy(v.copy()))
               for v in params.values()]
    opt = build_optimizer(tensors, "adam")
    tensors[0].grad = torch.ones_like(tensors[0])
    opt.step(1e-3)
    assert torch.equal(tensors[1].detach(),
                       torch.from_numpy(params["b"]))
    assert opt.count == 1 and float(opt.mu[1].abs().max()) == 0.0
    other = build_optimizer(tensors, "adam")
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and torch.equal(other.nu[0], opt.nu[0])
    opt.zero_grad()
    assert all(t.grad is None for t in tensors)


@pytest.mark.parametrize("name", ["rmsprop", "ranger", "madgrad", "adamp"])
def test_unported_optimizers_raise_and_name_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 10.9"):
        build_optimizer([], name)


@pytest.mark.parametrize("train_opt", [
    {"lr_scheme": "MultiStepLR", "lr_steps": [50000]},
    {"lr_steps": [10, 20, 40], "lr_gamma": 0.1, "lr_G": 3e-4},
    {"lr_scheme": "multistep", "lr_steps": [5], "warmup_iters": 8},
])
def test_multistep_schedule_matches_jax(train_opt):
    want = jax_sched.build_scheduler(dict(train_opt), base_lr=None)
    got = build_scheduler(dict(train_opt), base_lr=None)
    for step in list(range(0, 60)) + [49999, 50000, 50001, 10 ** 6]:
        assert got.get_lr(step) == want.get_lr(step), step


@pytest.mark.parametrize("scheme", ["CosineAnnealingLR_Restart", "StepLR",
                                    "ReduceLROnPlateau"])
def test_unported_schemes_raise_and_name_their_item(scheme):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 10.9"):
        build_scheduler({"lr_scheme": scheme})
