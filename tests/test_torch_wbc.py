"""White-box cartoonization against the JAX package on the CPU:
``UnetGeneratorWBC`` in both modes and ``tf_2x_bilinear``
(``models/wbcunet.py``) within 1e-5; the fixed-order reflect padding of
the guided filter's box means (``ops/filters.py::reflect_pad``) equal to
``F.pad``'s forward bit for bit, with the same gradient; three
``WBCTrainer`` steps (nf 8, a spectral-norm PatchGAN of ndf 8 for D_S and
D_T, b 2, 32 px, sgd at lr 1e-2, lsgan, VGG19 ``fea`` on structure and
content on seeded weights, ``tv``, 20 segments, identity 0.5, pools of
2) from one carried state, fed JAX's draws (the grey weights and the
gammas from the JAX step's key; the pools choose alike, seeded 0):
logs within 1e-4 relative; D_T's one-channel weights and a ``WBCState``
``.state`` both ways.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from test_torch_loss_stack import _vgg19_npz
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.models import wbcunet as jw
from trainner_tpu.train.wbc_trainer import WBCTrainer as JaxTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.models import wbcunet as pw
from trainner_tpu_torch.ops import filters as pf
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.wbc_trainer import WBCState, WBCTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (cyclegan_state_from_jax,
                                                    d_from_jax, d_to_jax,
                                                    g_from_jax,
                                                    load_train_state,
                                                    train_state_to_jax)

torch.set_num_threads(2)
BATCH, PX, STEPS, NF = 2, 32, 3, 8


def options(vgg, **train):
    opt = {"name": "wbc_steps", "model": "wbc", "scale": 1, "pool_size": 2,
           "datasets": {"train": {"name": "t", "mode": "unaligned",
                                  "dataroot_A": "/x", "dataroot_B": "/y",
                                  "crop_size": PX, "batch_size": BATCH}},
           "network_G": {"type": "wbcunet_net", "nf": NF},
           "network_D": {"type": "patchgan", "ndf": 8, "n_layers": 2,
                         "use_spectral_norm": True},
           "path": {"root": "/tmp/wbc_steps", "vgg_weights": vgg},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "lr_scheme": "MultiStepLR",
                     "lr_steps": [50], "gan_type": "lsgan",
                     "gan_weight": 1.0, "surf_scale": 0.1,
                     "struct_scale": 2.0, "content_scale": 2.0,
                     "reg_scale": 10.0, "feature_criterion": "l1",
                     "feature_weight": 1.0, "tv_type": "tv",
                     "tv_weight": 1.0, "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "lambda_identity": 0.5,
                     "idt_losses": ["pix"], "sp_n_segments": 20, **train}}
    return dict(parse_dict(opt, is_train=True))


def ab_batch(seed=0):
    """Smooth images in [0, 1]: a coarse field upsampled, a little
    noise."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in ("A", "B"):
        base = rng.rand(BATCH, 5, 5, 3)
        up = np.asarray(jax.image.resize(base, (BATCH, PX, PX, 3),
                                         "linear"))
        out[k] = np.clip(up + 0.02 * rng.rand(BATCH, PX, PX, 3), 0,
                         1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    return _vgg19_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")


@pytest.mark.parametrize("mode", ["pt", "tf"])
def test_generator_matches_jax(mode):
    """Both modes from the JAX parameters within 1e-5, and the TF-parity
    upsample alone."""
    x = ab_batch(1)["A"]
    jnet = jw.UnetGeneratorWBC(nf=NF, mode=mode)
    params = _redraw(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], 3, 1.0)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = pw.UnetGeneratorWBC(nf=NF, mode=mode)
    net.load_state_dict(g_from_jax(params, None, net))
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (BATCH, PX, PX, 3)
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())
    y = np.random.RandomState(2).rand(2, 5, 7, 4).astype(np.float32)
    np.testing.assert_allclose(pw.tf_2x_bilinear(torch.from_numpy(y)),
                               np.asarray(jw.tf_2x_bilinear(jnp.asarray(y))),
                               atol=1e-6)


def _old_separable(x, k1d):
    """The box filter as it stood: ``F.pad`` reflect on each axis."""
    k = torch.as_tensor(k1d, dtype=x.dtype)
    n, c = k.shape[0], x.shape[-1]
    pad = (n - 1) // 2
    y = F.pad(x.permute(0, 3, 1, 2), (0, 0, pad, n - 1 - pad),
              mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    y = F.pad(y, (pad, n - 1 - pad, 0, 0), mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("size", [3, 11, 4])
def test_reflect_pad_equals_f_pad(size):
    """``reflect_pad`` against ``F.pad`` reflect on each axis, forward bit
    for bit and the same gradient; the separable filter through it (the
    guided filter's box means) against its ``F.pad`` form: the forward
    bit for bit, the gradient within 1e-6."""
    gen = torch.Generator().manual_seed(size)
    x = torch.rand(2, 3, 13, 17, generator=gen, requires_grad=True)
    g = torch.rand(2, 3, 13 + size - 1, 17, generator=gen)
    lo, hi = (size - 1) // 2, size - 1 - (size - 1) // 2
    ours = pf.reflect_pad(x, 2, lo, hi)
    ref = F.pad(x, (0, 0, lo, hi), mode="reflect")
    assert torch.equal(ours, ref)
    (ga,) = torch.autograd.grad(ours, x, g)
    (gb,) = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
    img = torch.rand(2, 19, 23, 3, generator=gen, requires_grad=True)
    k = [1.0 / size] * size
    a = pf.separable_filter2d(img, k, "reflect")
    b = _old_separable(img, k)
    assert torch.equal(a, b)
    w = torch.rand(a.shape, generator=gen)
    (ga,) = torch.autograd.grad(a, img, w)
    (gb,) = torch.autograd.grad(b, img, w)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


def _jax_draws(jstate):
    """The JAX G step's draws from its state's key
    (``trainner_tpu/train/wbc_trainer.py:200-226``)."""
    _, r_rep, _ = jax.random.split(jstate.rng, 3)
    r1, r2 = jax.random.split(r_rep)
    k1, k2, k3 = jax.random.split(r1, 3)
    cs = {"r": jax.random.uniform(k1, (), minval=0.199, maxval=0.399),
          "g": jax.random.uniform(k2, (), minval=0.487, maxval=0.687),
          "b": jax.random.uniform(k3, (), minval=0.014, maxval=0.214)}
    gamma = jax.random.uniform(r2, (BATCH, 1, 1, 1), minval=1.0,
                               maxval=1.2)
    return {"cs": {k: torch.tensor(float(v)) for k, v in cs.items()},
            "gamma": torch.from_numpy(np.array(gamma))}


def _tree(jstate):
    return _numpy(serialization.to_state_dict(jstate))


@pytest.fixture(scope="module")
def run(vgg, tmp_path_factory):
    opt = options(vgg)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (BATCH, PX, PX, 3))
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 1.0)),
        d_s=template.d_s.replace(params=_redraw(template.d_s.params, 2,
                                                1.0)),
        d_t=template.d_t.replace(params=_redraw(template.d_t.params, 3,
                                                1.0)))
    pt = WBCTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, cyclegan_state_from_jax(_tree(jstate), pstate))
    tmp = tmp_path_factory.mktemp("wbc")
    steps = []
    for step in range(STEPS):
        batch = ab_batch(step)
        draws = _jax_draws(jstate)
        pt.draw_hook = lambda shapes, d=draws: d
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        steps.append({"logs": {k: float(v) for k, v in logs.items()},
                      "jlogs": {k: float(v) for k, v in jlogs.items()}})
        if step == 1:
            C.save_checkpoint(pstate, {"path": {
                "models": str(tmp / "port_models"),
                "training_state": str(tmp / "port_state")}}, 0, 2)
            JC.save_checkpoint(jstate, {"path": {
                "models": str(tmp / "jax_models"),
                "training_state": str(tmp / "jax_state")}}, 0, 2)
        # the next step from the JAX state (the pools go on as they are)
        load_train_state(pstate, cyclegan_state_from_jax(_tree(jstate),
                                                         pstate))
    return {"opt": opt, "jt": jt, "jstate": jstate, "template": template,
            "pt": pt, "pstate": pstate, "steps": steps, "tmp": tmp}


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_jax(run, step):
    """Each step of the port from the JAX state of that step, fed its
    draws: every log within 1e-4 relative."""
    rec = run["steps"][step]
    assert {"l_idt", "l_g_gan_S", "l_g_gan_T", "l_g_fea_struct",
            "l_g_fea_cont", "l_g_tv_reg", "l_g_total", "l_d_S",
            "l_d_T"} <= set(rec["logs"])
    _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)


def test_pools_make_the_jax_choices(run):
    for name in ("fake_s_pool", "fake_t_pool"):
        got, want = getattr(run["pt"], name), getattr(run["jt"], name)
        assert got.count == len(want.images) == 2
        assert got.rng.random() == want.rng.random()


def test_d_t_one_channel_weights_both_ways(run):
    """D_T reads one grey channel: the port builds it so, and its weights
    go to the JAX tree and back unchanged."""
    net = run["pstate"].d_t.net
    jd = run["jstate"].d_t
    params, stats = d_to_jax(net.state_dict(), net)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(_numpy(jd.params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(_numpy(jd.params))):
        assert a.shape == b.shape
    back = d_from_jax(params, stats, net)
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())
    first = [v for k, v in net.state_dict().items() if k.endswith("weight")]
    assert first[0].shape[1] == 1
    out = net(torch.rand(1, PX, PX, 1), train=False)
    assert torch.isfinite(out).all()


def test_state_files_cross_both_packages(run):
    """Both packages write ``2_G``, ``2_D_S``, ``2_D_T`` and ``2.state``;
    the JAX package loads the port's state and nets, and the port the JAX
    state (the step and every net)."""
    tmp = run["tmp"]
    names = {f"2_{n}.ckpt" for n in ("G", "D_S", "D_T")}
    assert names <= set(os.listdir(tmp / "port_models"))
    assert names <= set(os.listdir(tmp / "jax_models"))
    tmpl = run["template"]
    for n, leaf in (("G", tmpl.g.params), ("D_S", tmpl.d_s.params),
                    ("D_T", tmpl.d_t.params)):
        ours = JC.load_params(str(tmp / "port_models" / f"2_{n}.ckpt"), leaf)
        theirs = JC.load_params(str(tmp / "jax_models" / f"2_{n}.ckpt"),
                                leaf)
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(theirs)
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(theirs)):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-3
    loaded, meta = JC.load_state(str(tmp / "port_state" / "2.state"), tmpl)
    assert int(loaded.step) == 2 == meta["iter"]
    pt = WBCTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                    device="cpu")
    st, meta = C.load_state(str(tmp / "jax_state" / "2.state"),
                            pt.init_state(5))
    assert isinstance(st, WBCState) and st.step == 2
    want = cyclegan_state_from_jax(_tree(loaded), st)
    theirs = cyclegan_state_from_jax(_numpy(serialization.to_state_dict(
        JC.load_state(str(tmp / "jax_state" / "2.state"), tmpl)[0])), st)
    for w in ("g", "d_s", "d_t"):
        got = getattr(st, w).net.state_dict()
        assert all(torch.equal(got[k], v) for k, v in theirs[w].items())
        assert set(want[w]) == set(got)
    assert set(train_state_to_jax(st)) == {"step", "rng", "g", "d_s", "d_t"}
    x = torch.from_numpy(ab_batch(7)["A"])
    y = pt.eval_step(st, x, "g")
    want_y = np.asarray(run["jt"].eval_step(
        JC.load_state(str(tmp / "jax_state" / "2.state"), tmpl)[0],
        jnp.asarray(x.numpy())))
    assert np.abs(y.numpy() - want_y).max() < 1e-5
