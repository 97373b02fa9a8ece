"""Batch augmentations of the port (``trainner_tpu_torch/ops/batchaug.py``)
against the JAX package's (``trainner_tpu/ops/batchaug.py``) on the CPU:
each augmentation and the whole mixture fed the quantities JAX draws from
its keys (``jax_batchaug_draws`` replays the JAX package's key splits),
within 1e-6; the port's own draws (the choice, Beta, permutations, the
box, cutout's mask) against JAX's distributions from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import batchaug as jba
from trainner_tpu_torch.ops import batchaug as pba

torch.set_num_threads(2)

AUGS = ["blend", "rgb", "mixup", "cutmix", "cutmixup", "cutblur", "cutout"]
_DEFAULTS = {"cutout": {"alpha": 0.001}, "cutblur": {"alpha": 0.7}}


def _t(x):
    a = np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.long() if a.dtype.kind in "iu" else t


def _box(key, h, w):
    r1, r2, r3 = jax.random.split(key, 3)
    return {"n": _t(jax.random.normal(r1, ())),
            "cy": _t(jax.random.randint(r2, (), 0, h)),
            "cx": _t(jax.random.randint(r3, (), 0, w))}


def jax_aug_draw(name: str, key, shape, **kw) -> dict:
    """The quantities the JAX augmentation ``name`` draws from ``key``,
    with its alpha (``kw``)."""
    b, h, w, c = shape
    if name == "blend":
        alpha = kw.get("alpha", 0.6)
        r1, r2 = jax.random.split(key)
        return {"c": _t(jax.random.uniform(r1, (b, 1, 1, c))),
                "v": _t(alpha + (1 - alpha) * jax.random.uniform(r2, ()))}
    if name == "rgb":
        return {"perm": _t(jax.random.permutation(key, c))}
    if name == "mixup":
        alpha = kw.get("alpha", 1.2)
        r1, r2 = jax.random.split(key)
        return {"lam": _t(jax.random.beta(r1, alpha, alpha)),
                "perm": _t(jax.random.permutation(r2, b))}
    if name == "cutmix":
        r1, r2, r3 = jax.random.split(key, 3)
        return {"lam": _t(jax.random.uniform(r1, (), minval=0.0,
                                             maxval=kw.get("alpha", 0.7))),
                **_box(r2, h, w), "perm": _t(jax.random.permutation(r3, b))}
    if name == "cutmixup":
        r1, r2, r3, r4 = jax.random.split(key, 4)
        return {"lam": _t(jax.random.beta(r1, 1.2, 1.2)),
                "u": _t(jax.random.uniform(r2, (), maxval=0.7)),
                **_box(r3, h, w), "perm": _t(jax.random.permutation(r4, b))}
    if name == "cutblur":
        r1, r2, r3 = jax.random.split(key, 3)
        return {"u": _t(jax.random.uniform(r1, (),
                                           maxval=kw.get("alpha", 0.7))),
                **_box(r2, h, w), "inside": _t(jax.random.bernoulli(r3))}
    keep = 1.0 - kw.get("alpha", 0.001)
    return {"keep": _t(jax.random.bernoulli(key, keep, (b, h, w, 1)))}


def jax_batchaug_draws(ba, key, shape) -> dict:
    """What the JAX ``BatchAugment`` ``ba`` draws from ``key``: the choice
    and, for every augmentation of the mixture, what it would draw were it
    chosen, in the port's form."""
    r_choice, r_aug = jax.random.split(key)
    idx = jax.random.categorical(r_choice, jnp.log(ba.probs + 1e-12))
    out = {"choice": {"idx": _t(idx)}}
    for name in ba.augs:
        if name != "none" and name not in out:
            kw = dict(_DEFAULTS.get(name, {}))
            if name in ba.alphas:
                kw["alpha"] = ba.alphas[name]
            out[name] = jax_aug_draw(name, r_aug, shape, **kw)
    return out


def _pair(shape=(4, 16, 16, 3), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


@pytest.mark.parametrize("name", AUGS)
def test_each_augmentation_on_jax_draws_matches_jax(name):
    """Each augmentation of (hr, lr) from one key, over five keys: both
    outputs (cutout: the input and the mask) within 1e-6 of JAX's."""
    hr, lr = _pair()
    fn = jba.rgb_perm if name == "rgb" else getattr(jba, name)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        draws = {k: v for k, v in jax_aug_draw(
            name, key, hr.shape, **_DEFAULTS.get(name, {})).items()}
        if name == "cutout":
            want = fn(key, jnp.asarray(lr), 0.001)
            got = pba.cutout(torch.from_numpy(lr), draws)
        else:
            want = fn(key, jnp.asarray(hr), jnp.asarray(lr))
            got = {"blend": pba.blend, "rgb": pba.rgb_perm,
                   "mixup": pba.mixup, "cutmix": pba.cutmix,
                   "cutmixup": pba.cutmixup, "cutblur": pba.cutblur}[name](
                torch.from_numpy(hr), torch.from_numpy(lr), draws)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6, seed


@pytest.mark.parametrize("probs", [None, [1, 2, 3, 1, 1, 2, 1, 5]])
def test_mixture_on_jax_draws_matches_jax(probs):
    """``BatchAugment`` over every augmentation and ``none``: over twelve
    keys (several choices each), the port's apply on JAX's draws gives
    JAX's (hr, lr, mask) within 1e-6."""
    augs = AUGS + ["none"]
    alphas = {"mixup": 0.4, "blend": 0.5}
    jb = jba.BatchAugment(augs, probs, alphas)
    pb = pba.BatchAugment(augs, probs, alphas)
    hr, lr = _pair(seed=2)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(100 + seed)
        h2, l2, m, idx = jb(key, jnp.asarray(hr), jnp.asarray(lr))
        seen.add(int(idx))
        got = pb.apply(jax_batchaug_draws(jb, key, hr.shape),
                       torch.from_numpy(hr), torch.from_numpy(lr))
        for g, w in zip(got, (h2, l2, m)):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6, seed
    assert len(seen) >= 4


def _ks(a, b) -> float:
    grid = np.union1d(a, b)
    return float(np.abs(
        np.searchsorted(np.sort(a), grid, side="right") / a.size
        - np.searchsorted(np.sort(b), grid, side="right") / b.size).max())


@pytest.mark.parametrize("alpha", [0.4, 1.2, 3.0])
def test_beta_draws_follow_jax(alpha):
    """2000 Beta(alpha, alpha) draws of the port's gamma route against
    2000 of ``jax.random.beta``: KS distance under 0.06 (1 % critical
    value 0.052), and the mean within 0.02 of 1/2."""
    gen = torch.Generator().manual_seed(4)
    mine = pba.beta(gen, alpha, (2000,), "cpu").double().numpy()
    theirs = np.asarray(jax.random.beta(jax.random.PRNGKey(4), alpha, alpha,
                                        (2000,)), np.float64)
    # f32 rounds the draws nearest the ends to 0 or 1 at small alpha
    assert ((mine >= 0) & (mine <= 1)).all()
    assert abs(mine.mean() - 0.5) < 0.02
    assert _ks(mine, theirs) < 0.06


def test_choice_permutation_and_mask_follow_jax():
    """The choice over unequal probabilities (3000 draws each: every
    frequency within 0.03 of JAX's), the permutations (3000 of 5: each
    position's value frequency within 0.03 of 1/5), the box draws (KS
    under 0.06) and cutout's mask (keep share within 3e-3 of JAX's)."""
    augs = ["blend", "rgb", "mixup", "none"]
    probs = [1.0, 2.0, 3.0, 4.0]
    pb = pba.BatchAugment(augs, probs)
    jb = jba.BatchAugment(augs, probs)
    gen = torch.Generator().manual_seed(6)
    mine = np.array([int(pb.draw(gen, (2, 4, 4, 3), "cpu")["choice"]["idx"])
                     for _ in range(3000)])
    keys = jax.random.split(jax.random.PRNGKey(6), 3000)
    theirs = np.asarray(jax.vmap(lambda k: jax.random.categorical(
        jax.random.split(k)[0], jnp.log(jb.probs + 1e-12)))(keys))
    for i in range(4):
        assert abs((mine == i).mean() - (theirs == i).mean()) < 0.03
        assert abs((mine == i).mean() - probs[i] / 10) < 0.03
    perms = np.stack([pba.permutation(gen, 5, "cpu").numpy()
                      for _ in range(3000)])
    assert (np.sort(perms, 1) == np.arange(5)).all()
    for pos in range(5):
        freq = np.bincount(perms[:, pos], minlength=5) / 3000
        assert np.abs(freq - 0.2).max() < 0.03
    boxes = [pba._draw_box(gen, 16, 16, "cpu") for _ in range(1000)]
    jboxes = [_box(k, 16, 16) for k in keys[:1000]]
    for leaf in ("n", "cy", "cx"):
        assert _ks(np.array([float(b[leaf]) for b in boxes]),
                   np.array([float(b[leaf]) for b in jboxes])) < 0.06
    keep = pba.draw_cutout(gen, (8, 64, 64, 3), "cpu", 0.05)["keep"]
    jkeep = jax_aug_draw("cutout", keys[0], (8, 64, 64, 3), alpha=0.05)
    assert abs(float(keep.float().mean()) - float(
        jkeep["keep"].float().mean())) < 3e-3


def test_unknown_augmentation_raises():
    with pytest.raises(ValueError, match="bogus"):
        pba.BatchAugment(["blend", "bogus"])
