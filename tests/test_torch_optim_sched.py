"""The port's optimizers and schedules (``trainner_tpu_torch/train/
optimizers.py``, ``schedulers.py``) against the JAX package's optax chains
and host-side schedules: every rule over several steps on given gradients
(AdamP's projection firing, in the JAX layout of a conv weight), every
scheme's ``get_lr`` with warmup and the SWA switch-over, the plateau
state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.train import optimizers as jax_opt
from trainner_tpu.train import schedulers as jax_sched
from trainner_tpu_torch.train.optimizers import (_cbrt, build_optimizer,
                                                 jax_view)
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


@pytest.mark.parametrize("name,kw", [
    ("rmsprop", {}), ("rmsprop", {"weight_decay": 0.01}),
    ("adamp", {}), ("adamp", {"weight_decay": 0.01}),
    ("sgdp", {}), ("sgdp", {"weight_decay": 0.01, "momentum": 0.5}),
    ("ranger", {}), ("ranger", {"weight_decay": 0.01}),
    ("ranger", {"beta1": 0.8, "use_gc": True}),
    ("madgrad", {}), ("madgrad", {"weight_decay": 0.01}),
    ("madgrad", {"momentum": 0.0}),
])
def test_other_optimizers_match_optax(name, kw):
    """The other rules of ``build_optimizer``, six steps as above (ranger
    syncs its Lookahead at the sixth): the parameters within 5e-7 of the
    JAX package's after every step, each state list equal to optax's
    within the same."""
    params, grads, lrs = _data()
    want = _run_jax(name, params, grads, lrs, **kw)
    got, opt = _run_port(name, params, grads, lrs, **kw)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert np.abs(g[k] - w[k]).max() < 5e-7, (step, k)
    if name == "ranger":
        assert int(opt.la_count) == 6 and int(opt.count) == 6


def _orthogonal_grads(params, seed):
    """Gradients orthogonal to each weight row by row (a scale-invariant
    weight's), so that AdamP's channel projection fires."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        g = {}
        for k, p in params.items():
            r = rng.randn(*p.shape).astype(np.float32)
            if p.ndim > 1:
                rows, pr = r.reshape(p.shape[0], -1), p.reshape(p.shape[0], -1)
                rows -= pr * (rows * pr).sum(1, keepdims=True) / (
                    pr * pr).sum(1, keepdims=True)
                r = rows.reshape(p.shape)
            g[k] = (r * 1e-2).astype(np.float32)
        out.append(g)
    return out


@pytest.mark.parametrize("name", ["adamp", "sgdp"])
def test_projection_fires_and_matches_optax(name):
    """Gradients orthogonal to the weights: the projection removes the
    radial part and the decay shrinks by wd_ratio; six steps within 5e-7
    of the JAX rule, and the weights' norms kept to 1e-3 where a plain
    step of this size would grow them."""
    params, _, lrs = _data(7)
    grads = _orthogonal_grads(params, 8)
    kw = {"weight_decay": 0.01}
    want = _run_jax(name, params, grads, lrs, **kw)
    got, _ = _run_port(name, params, grads, lrs, **kw)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert np.abs(g[k] - w[k]).max() < 5e-7, (step, k)
    for k in ("w", "lin"):
        assert abs(np.linalg.norm(got[-1][k]) / np.linalg.norm(params[k])
                   - 1) < 1e-3


def test_projection_reads_the_jax_layout():
    """A conv weight in the port's OIHW beside the same weight in JAX's
    HWIO: with ``views`` the port projects per row of the HWIO layout and
    lands where optax does (without, the rows would be the OIHW ones)."""
    rng = np.random.RandomState(9)
    hwio = rng.randn(3, 3, 4, 5).astype(np.float32)
    grads = [rng.randn(3, 3, 4, 5).astype(np.float32) * 1e-2
             for _ in range(3)]
    want = _run_jax("adamp", {"w": hwio}, [{"w": g} for g in grads],
                    [1e-2] * 3)
    p = torch.nn.Parameter(torch.from_numpy(
        np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))))
    opt = build_optimizer([p], "adamp", views=[jax_view(p)])
    for g in grads:
        p.grad = torch.from_numpy(np.ascontiguousarray(
            g.transpose(3, 2, 0, 1)))
        opt.step(1e-2)
    got = p.detach().numpy().transpose(2, 3, 1, 0)
    assert np.abs(got - want[-1]["w"]).max() < 5e-7


@pytest.mark.parametrize("value", [0.0, 1e-30, 2.5e-7, 0.3, 8.0, 7e12])
def test_cube_root_is_rounded_once(value):
    """Madgrad's cube root is the f64 cube root rounded once to f32: the
    nearest f32, which XLA's ``jnp.cbrt`` is not always (an ulp above at
    7e12, two below at 2.5e-7, ten at 1e-30): within 1e-6 relative of
    it."""
    x = torch.tensor([value], dtype=torch.float32)
    exact = np.float32(np.cbrt(np.float64(np.float32(value))))
    want = np.asarray(jnp.cbrt(jnp.asarray([value], jnp.float32)))[0]
    got = _cbrt(x).numpy()[0]
    assert got == exact
    assert abs(got - want) <= 1e-6 * abs(want)


SCHEDULES = [
    {"lr_scheme": "CosineAnnealingLR_Restart", "T_period": [10, 20, 15],
     "restart_weights": [1.0, 0.5, 0.25], "eta_min": 1e-7},
    {"lr_scheme": "StepLR", "lr_step_size": 7, "lr_gamma": 0.3},
    {"lr_scheme": "ReduceLROnPlateau", "plateau_min_lr": 1e-6},
    {"lr_scheme": "MultiStepLR_Restart", "lr_steps": [5, 15, 25],
     "restarts": [10, 20], "restart_weights": [0.5, 0.25]},
    {"lr_scheme": "multistep_restart", "lr_steps": [3, 30]},
    {"lr_scheme": "StepLR_Restart", "lr_step_sizes": [4, 9]},
    {"lr_scheme": "step"},
    {"lr_scheme": "ProgressiveMultiStepLR", "lr_steps": [6, 12]},
    {"lr_scheme": "CosineAnnealingLR", "T_max": 25, "eta_min": 1e-6},
    {"lr_scheme": "cosine"},
    {"lr_scheme": "cosine_restart", "T_period": [8]},
    {"lr_scheme": "Linear", "fixed_niter": 10},
    {"lr_scheme": "LambdaLR", "fixed_niter_rel": 5},
    {"lr_scheme": "FlatCosineDecay", "fixed_niter": 20},
    {"lr_scheme": "flatcosine"},
    {"lr_scheme": "plateau"},
    {"lr_scheme": "CosineAnnealingLR", "T_max": 30, "warmup_iters": 6},
    {"lr_scheme": "StepLR", "lr_step_size": 5, "swa_start_iter": 12,
     "swa_lr": 3e-5},
    {"lr_scheme": "MultiStepLR", "lr_steps": [4], "swa_start_iter": 0,
     "swa_lr": 1e-5, "warmup_iters": 3},
]


@pytest.mark.parametrize("train_opt", SCHEDULES)
def test_every_schedule_matches_jax(train_opt):
    """Every scheme of ``build_scheduler`` with its aliases, with warmup
    and the SWA switch-over (a constant ``swa_lr`` strictly past
    ``swa_start_iter``): ``get_lr`` equal to the JAX schedule's (both f64
    on the host) over the first 60 steps, around the boundaries and far
    out, at niter 50."""
    want = jax_sched.build_scheduler(dict(train_opt), base_lr=3e-4,
                                     niter=50)
    got = build_scheduler(dict(train_opt), base_lr=3e-4, niter=50)
    for step in list(range(0, 60)) + [99, 100, 101, 10 ** 6]:
        assert got.get_lr(step) == want.get_lr(step), step
    assert got.get_lrs(3, 4) == [want.get_lr(s) for s in range(3, 7)]


def test_plateau_state_steps_and_round_trips_as_jax():
    """``plateau_step`` on one metric sequence moves both schedules
    alike (patience 2, mode max, factor 0.5, the floor ``plateau_min_lr``);
    ``state_dict`` / ``load_state_dict`` carry it into a fresh one."""
    t = {"lr_scheme": "ReduceLROnPlateau", "plateau_patience": 2,
         "plateau_min_lr": 2e-5, "plateau_threshold": 1e-3}
    want = jax_sched.build_scheduler(dict(t), base_lr=1e-4)
    got = build_scheduler(dict(t), base_lr=1e-4)
    metrics = [20.0, 20.5, 20.5004, 20.4, 20.3, 20.1, 21.0, 20.0, 19.0,
               18.0, 17.0, 16.0, 15.0, 14.0]
    for m in metrics:
        want.plateau_step(m)
        got.plateau_step(m)
        assert got.get_lr(5) == want.get_lr(5)
        assert got.state_dict() == want.state_dict()
    assert got.get_lr(5) == 2e-5
    fresh = build_scheduler(dict(t), base_lr=1e-4)
    fresh.load_state_dict(got.state_dict())
    assert fresh.get_lr(0) == got.get_lr(0)


def test_unknown_scheme_raises():
    with pytest.raises(NotImplementedError, match="bogus"):
        build_scheduler({"lr_scheme": "bogus"})
    with pytest.raises(NotImplementedError, match="bogus"):
        build_optimizer([], "bogus")


@pytest.mark.parametrize("count", [1, 2, 3, 1000, 12345])
@pytest.mark.parametrize("beta1,beta2", [(0.9, 0.999), (0.5, 0.9)])
def test_bias_corrections_are_optax_f32_scalars(count, beta1, beta2):
    """Adam's corrections 1 - beta**count are f32 scalars on the count's
    device, equal to optax's ``1 - decay**count`` under XLA on the CPU (an
    int32 count; f32 binary exponentiation), not the host's f64 values:
    at count 1000 those differ by 4.9e-6 relative."""
    opt = build_optimizer([torch.nn.Parameter(torch.zeros(3))], "adam",
                          beta1=beta1, beta2=beta2)
    opt.count.fill_(count)
    c1, c2 = opt._corrections()
    for got, beta in ((c1, beta1), (c2, beta2)):
        want = np.asarray(1 - beta ** jnp.asarray(count, jnp.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy() == want, (beta, count, float(got), want)


def test_adam_step_at_count_1000_matches_optax():
    """One step from moments and a count of 999 carried into both: the
    parameters within 5e-7 of the optax chain's, as in the trajectory
    test, with the corrections at count 1000."""
    params, grads, _ = _data(4)
    rng = np.random.RandomState(5)
    mu = {k: (rng.randn(*s) * 1e-3).astype(np.float32)
          for k, s in SHAPES.items()}
    nu = {k: (rng.rand(*s) * 1e-6).astype(np.float32)
          for k, s in SHAPES.items()}
    jopt = jax_opt.build_optimizer("adam")
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(p)
    state = (state[0]._replace(
        count=jnp.asarray(999, jnp.int32),
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()}),) + tuple(state[1:])
    p, _ = jopt.apply({k: jnp.asarray(v) for k, v in grads[0].items()},
                      state, p, 1e-3)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = build_optimizer(list(tensors.values()), "adam")
    opt.load_state_dict({"count": 999,
                         "mu": [torch.from_numpy(mu[k]) for k in tensors],
                         "nu": [torch.from_numpy(nu[k]) for k in tensors]})
    for k, t in tensors.items():
        t.grad = torch.from_numpy(grads[0][k].copy())
    opt.step(torch.tensor(1e-3, dtype=torch.float32))
    assert int(opt.count) == 1000
    for k, t in tensors.items():
        assert np.abs(t.detach().numpy() - np.asarray(p[k])).max() < 5e-7, k


def test_lr_tensor_equals_float_and_state_keeps_an_int_count():
    """``step`` takes the learning rate as a 0-d f32 tensor (what a graph
    replays) or a float (made into one): the same update bit for bit. The
    count lives on the parameters' device; ``state_dict`` gives it as an
    int, the JAX format's, and ``load_state_dict`` writes it and the
    moments in place (the same storage: a graph that captured them stays
    valid)."""
    params, grads, lrs = _data(6)
    runs = []
    for as_tensor in (False, True):
        tensors = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for v in params.values()]
        opt = build_optimizer(tensors, "adam", weight_decay=0.01)
        for g, lr in zip(grads[:3], lrs[:3]):
            for t, k in zip(tensors, params):
                t.grad = torch.from_numpy(g[k].copy())
            opt.step(torch.tensor(lr, dtype=torch.float32) if as_tensor
                     else lr)
        runs.append((tensors, opt))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    opt = runs[1][1]
    assert isinstance(opt.count, torch.Tensor)
    assert opt.count.dtype == torch.int32
    saved = opt.state_dict()
    assert type(saved["count"]) is int and saved["count"] == 3
    other = build_optimizer(runs[0][0], "adam")
    ptrs = [t.data_ptr() for t in [other.count] + other.mu + other.nu]
    other.load_state_dict(saved)
    assert ptrs == [t.data_ptr() for t in [other.count] + other.mu + other.nu]
    assert int(other.count) == 3
    for a, b in zip(other.mu + other.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
