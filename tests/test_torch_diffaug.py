"""DiffAugment of the port (``trainner_tpu_torch/ops/diffaug.py``) against
the JAX package's (``trainner_tpu/ops/diffaug.py``) on the CPU: every
policy's apply, fed the quantities JAX draws from its keys (``jax_draws``
replays the JAX package's key splits), within 1e-6, and its gradient with
respect to the input within 1e-6; the port's own draws against JAX's
distributions from fixed seeds (the streams cannot match, ROADMAP C 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import diffaug as jda
from trainner_tpu_torch.ops import diffaug as pda

torch.set_num_threads(2)

# policy -> its transforms in the JAX package's order
JAX_FNS = {"color": ["brightness", "saturation", "contrast"],
           "translation": ["translation"], "cutout": ["cutout"],
           "flip": ["flip"], "rotate": ["rotate"], "zoom_in": ["zoom_in"],
           "zoom_out": ["zoom_out"], "offset": ["offset"],
           "offset_h": ["offset_h"], "offset_v": ["offset_v"]}
POLICIES = list(JAX_FNS)


def _t(x):
    a = np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.long() if a.dtype.kind in "iu" else t


def _jax_draw(name: str, key, shape) -> dict:
    """The quantities the JAX transform ``name`` draws from ``key``."""
    b, h, w, _ = shape
    r1, r2 = jax.random.split(key)
    if name in ("brightness", "saturation", "contrast"):
        return {"u": _t(jax.random.uniform(key, (b, 1, 1, 1)))}
    if name == "translation":
        rh, rw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
        return {"ty": _t(jax.random.randint(r1, (b,), -rh, rh + 1)),
                "tx": _t(jax.random.randint(r2, (b,), -rw, rw + 1))}
    if name == "cutout":
        ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
        return {"oy": _t(jax.random.randint(r1, (b,), 0, h + (1 - ch % 2))),
                "ox": _t(jax.random.randint(r2, (b,), 0, w + (1 - cw % 2)))}
    if name == "flip":
        return {"flip": _t(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1)))}
    if name == "rotate":
        return {"k": _t(jax.random.randint(key, (), 0, 4))}
    if name == "zoom_in":
        hz, wz = int(h * 1.25), int(w * 1.25)
        return {"oy": _t(jax.random.randint(r1, (), 0, hz - h + 1)),
                "ox": _t(jax.random.randint(r2, (), 0, wz - w + 1))}
    if name == "zoom_out":
        hz, wz = int(h * 0.8), int(w * 0.8)
        return {"oy": _t(jax.random.randint(r1, (), 0, h - hz + 1)),
                "ox": _t(jax.random.randint(r2, (), 0, w - wz + 1))}
    rv = 0 if name == "offset_h" else int(h + 0.5)
    rh = 0 if name == "offset_v" else int(w + 0.5)
    return {"sh": _t(jax.random.randint(r1, (), -rv, rv + 1)),
            "sw": _t(jax.random.randint(r2, (), -rh, rh + 1))}


def jax_draws(key, policy: str, shape) -> list:
    """What ``diff_augment(key, x, policy)`` draws, transform by
    transform, in the port's form."""
    out, rng = [], key
    for p in [q.strip() for q in policy.split(",") if q.strip()]:
        for name in JAX_FNS[p]:
            rng, sub = jax.random.split(rng)
            out.append(_jax_draw(name, sub, shape))
    return out


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("policy", POLICIES + [
    "color,translation,cutout", "flip,rotate,zoom_in,zoom_out,offset"])
def test_policy_on_jax_draws_matches_jax(policy):
    """Each policy (and two chains) on a 4 x 24 x 24 x 3 batch: the output
    within 1e-6 of the JAX function's from the same key, and the gradient
    of a weighted sum with respect to the input within 1e-6 (every apply
    is differentiable in its input)."""
    shape = (4, 24, 24, 3)
    x = _x(shape)
    wts = _x(shape, 1)
    key = jax.random.PRNGKey(7)

    def jfn(v):
        return jnp.sum(jda.diff_augment(key, v, policy) * wts)

    want = np.asarray(jda.diff_augment(key, jnp.asarray(x), policy))
    want_g = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pda.apply_diff_augment(xt, policy, jax_draws(key, policy, shape))
    (got * torch.from_numpy(wts)).sum().backward()
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-6
    assert np.abs(xt.grad.numpy() - want_g).max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_draws_give_fake_and_real_one_transform(seed):
    """One set of draws applied to two batches moves both alike: the
    translation, cutout and flip of a batch of ones land where they land
    for the batch of twos."""
    shape = (6, 16, 16, 3)
    draws = pda.draw_diff_augment(torch.Generator().manual_seed(seed),
                                  "translation,cutout,flip,rotate", shape,
                                  "cpu")
    ones = torch.ones(shape)
    a = pda.apply_diff_augment(ones, "translation,cutout,flip,rotate", draws)
    b = pda.apply_diff_augment(2 * ones, "translation,cutout,flip,rotate",
                               draws)
    assert torch.equal(2 * a, b)


def _port_samples(name, shape, n):
    gen = torch.Generator().manual_seed(3)
    policy = {"brightness": "color"}.get(name, name)
    return [pda.draw_diff_augment(gen, policy, shape, "cpu")[0]
            for _ in range(n)]


@pytest.mark.parametrize("name,leaf", [
    ("brightness", "u"), ("translation", "ty"), ("cutout", "ox"),
    ("flip", "flip"), ("rotate", "k"), ("zoom_in", "oy"),
    ("zoom_out", "ox"), ("offset", "sw"), ("offset_v", "sh")])
def test_port_draws_follow_jax_distributions(name, leaf):
    """400 draws of each quantity from the port's generator against 400
    from JAX's keys: the same support, and the two-sample
    Kolmogorov-Smirnov distance under 0.12 (its 1 % critical value at
    these sizes is 0.115)."""
    shape = (4, 20, 20, 3)
    mine = torch.cat([d[leaf].reshape(-1).double()
                      for d in _port_samples(name, shape, 400)]).numpy()
    keys = jax.random.split(jax.random.PRNGKey(11), 400)
    theirs = np.concatenate([
        _jax_draw(name, k, shape)[leaf].reshape(-1).double().numpy()
        for k in keys])
    if name != "brightness":  # integers and flips: one support
        assert np.array_equal(np.unique(mine), np.unique(theirs))
    grid = np.union1d(mine, theirs)
    cdf = [np.searchsorted(np.sort(v), grid, side="right") / v.size
           for v in (mine, theirs)]
    assert np.abs(cdf[0] - cdf[1]).max() < 0.12


def test_unknown_policy_raises():
    with pytest.raises(KeyError, match="bogus"):
        pda.diff_augment(torch.zeros(1, 4, 4, 3), "color,bogus")
