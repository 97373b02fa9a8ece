"""pix2pix's trainer (``trainner_tpu_torch/train/pix2pix_trainer.py``)
against the JAX ``Pix2PixTrainer`` on the CPU, from one carried state, at
a narrow width: the U-Net (num_downs 5, ngf 8, batch norm) and PatchGAN
(ndf 8, 3 layers, batch norm) on 32 px A/B pairs, b=2, sgd at lr 1e-2,
pixel L1 x 100 and the conditional vanilla GAN. Three steps: every log
within 1e-4 relative, every G and D tensor (running statistics included)
within 1e-3 of its largest update plus 2e-7. Dropout is off there (the
two packages draw different masks); ``use_dropout`` is held on its own:
its rate, its 2x scale, a new mask per step from the state's generator,
and eval with neither dropout nor batch statistics.

ROADMAP C 22, held here: the conditional D sees A before the image (6
channels, from the trainer); the G stage's D pass leaves D's statistics
as they were, the D stage keeps the real pass's; the template's
``aligned`` mode gives LR/HR, which pix2pix does not read.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax,
                                                    train_state_to_jax)

torch.set_num_threads(2)
BATCH, PX, STEPS = 2, 32, 3


def options(**g):
    opt = {"name": "p2p_steps", "model": "pix2pix", "scale": 1,
           "datasets": {"train": {"name": "t", "mode": "unaligned",
                                  "dataroot_A": "/x", "dataroot_B": "/y",
                                  "crop_size": PX, "batch_size": BATCH,
                                  "znorm": True}},
           "network_G": {"type": "unet_net", "num_downs": 5, "ngf": 8,
                         "norm_type": "batch", "use_dropout": False, **g},
           "network_D": {"type": "patchgan", "ndf": 8, "n_layers": 3},
           "path": {"root": "/tmp/p2p_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 100.0, "gan_type": "vanilla",
                     "gan_weight": 1.0, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50]}}
    return dict(parse_dict(opt, is_train=True))


def ab_batch(seed=0, n=BATCH, px=PX):
    rng = np.random.RandomState(seed)
    return {k: (rng.rand(n, px, px, 3) * 2 - 1).astype(np.float32)
            for k in ("A", "B")}


def carried(jstate, pstate):
    """The JAX state's numpy leaves as the port's ``load_train_state``
    takes them."""
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra.get("batch_stats")), int(jstate.step),
        g_net=pstate.g.net,
        g_batch_stats=_numpy(jstate.g.extra.get("batch_stats")),
        d_net=pstate.d.net)


def sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def check_tensors(got, want, old, step, label):
    """Each tensor within 1e-3 of its largest update plus 2e-7; where a
    ReLU-class branch takes the other side in one package (an input that
    rounds across the kink: ROADMAP C 15, which the norms' unit-spread
    outputs make common), the elements it feeds move by their whole share
    in either package alike, so such a tensor is held in L2 norm: within
    1e-2 of its update."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k, w in want.items():
        moved = np.abs(w - old[k]).max()
        err = np.abs(got[k] - w).max()
        if err <= 1e-3 * moved + 2e-7:
            continue
        l2 = np.linalg.norm(got[k] - w)
        assert moved > 1e-6 and l2 <= 1e-2 * np.linalg.norm(w - old[k]), \
            (step, label, k, err, moved)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    opt = options()
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (BATCH, PX, PX, 3))
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 1.0)),
        d=template.d.replace(params=_redraw(template.d.params, 2, 1.0)))
    pt = Pix2PixTrainer(copy.deepcopy(opt), dtype=torch.float32,
                        device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, carried(jstate, pstate))
    tmp = tmp_path_factory.mktemp("p2p")
    steps = []
    for step in range(STEPS):
        batch = ab_batch(step)
        before = {"g": sd(pstate.g.net), "d": sd(pstate.d.net)}
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = carried(jstate, pstate)
        steps.append({"logs": {k: float(v) for k, v in logs.items()},
                      "jlogs": {k: float(v) for k, v in jlogs.items()},
                      "before": before,
                      "after": {"g": sd(pstate.g.net), "d": sd(pstate.d.net)},
                      "want": {w: {k: v.numpy() for k, v in want[w].items()}
                               for w in ("g", "d")}})
        if step == 1:
            C.save_state(pstate, str(tmp / "port.state"), epoch=0)
            JC.save_state(jstate, str(tmp / "jax.state"), epoch=0)
    return {"opt": opt, "jt": jt, "jstate": jstate, "template": template,
            "pt": pt, "pstate": pstate, "steps": steps, "tmp": tmp}


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_jax(run, step):
    rec = run["steps"][step]
    _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)
    assert {"l_g_pix", "l_g_gan", "l_d_real", "l_d_fake"} <= set(rec["logs"])
    for w in ("g", "d"):
        check_tensors(rec["after"][w], rec["want"][w], rec["before"][w],
                      step, w)


def test_d_reads_a_and_b_and_keeps_the_real_pass_statistics(run):
    """The conditional D takes 6 channels (A before the image); after a
    step its running statistics are those of its D-stage pass on A and B,
    from its weights before the update: the G stage's pass (on A and
    G(A)) and the fake pass leave none."""
    assert run["pstate"].d.net.conv0.weight.shape[1] == 6
    pt = Pix2PixTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                        device="cpu")
    st = pt.init_state(3)
    batch = {k: torch.from_numpy(v) for k, v in ab_batch(9).items()}
    d = copy.deepcopy(st.d.net)
    d(torch.cat([batch["A"], batch["B"]], -1), train=True)
    want = [m.pending for m in d.norms()]
    pt.train_step(st, batch)
    got = [(m.running_mean, m.running_var) for m in st.d.net.norms()]
    assert len(got) == len(want) == 3
    for (gm, gv), (wm, wv) in zip(got, want):
        assert torch.equal(gm, wm) and torch.equal(gv, wv)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_each_package_resumes_from_the_other_state(run, source):
    """The ``.state`` of step 2 from either package: the port resumes from
    it and takes step 3 as the unbroken run did; the JAX package loads the
    port's."""
    pt = Pix2PixTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                        device="cpu")
    pstate = pt.init_state(7)
    pstate, meta = C.load_state(str(run["tmp"] / f"{source}.state"), pstate)
    assert pstate.step == 2 == meta["iter"]
    pstate, logs = pt.train_step(
        pstate, {k: torch.from_numpy(v) for k, v in ab_batch(2).items()})
    _check_logs({k: float(v) for k, v in logs.items()},
                run["steps"][2]["jlogs"], 1e-4, 2)
    if source == "port":
        loaded, meta = JC.load_state(str(run["tmp"] / "port.state"),
                                     run["template"])
        assert int(loaded.step) == 2
        got = serialization.to_state_dict(loaded)
        want = train_state_to_jax(C.load_state(
            str(run["tmp"] / "port.state"), Pix2PixTrainer(
                copy.deepcopy(run["opt"]), dtype=torch.float32,
                device="cpu").init_state(0))[0])
        for k in ("params", "extra"):
            a = jax.tree_util.tree_leaves(got["g"][k])
            b = jax.tree_util.tree_leaves(want["g"][k])
            assert len(a) == len(b) and all(
                np.array_equal(np.asarray(x), y) for x, y in zip(a, b))


def test_eval_step_matches_jax(run):
    """G in eval mode (running statistics, no dropout) against the JAX
    ``eval_step``."""
    x = ab_batch(11)["A"]
    want = np.asarray(run["jt"].eval_step(run["jstate"], jnp.asarray(x)))
    got = run["pt"].eval_step(run["pstate"], torch.from_numpy(x),
                              "g").numpy()
    assert np.abs(got - want).max() < 1e-5


def test_dropout_rate_scale_and_fresh_masks():
    """``use_dropout``: the 8 ngf levels' dropout keeps about half of the
    elements, scales them by 2, draws a new mask from the state's
    generator each step, and is off in eval (two eval calls agree)."""
    opt = options(use_dropout=True, num_downs=6)
    pt = Pix2PixTrainer(opt, dtype=torch.float32, device="cpu")
    st = pt.init_state(0)
    drops = list(st.g.net.dropouts.values())
    assert len(drops) == 2 and all(d.generator is st.noise_generator
                                   for d in drops)
    x = torch.randn(4, 64, 16, 16)
    drops[0].train()
    masks = []
    for _ in range(2):
        y = drops[0](x)
        kept = y != 0
        assert torch.allclose(y[kept], 2 * x[kept])
        share = kept.float().mean().item()
        assert 0.45 < share < 0.55
        masks.append(kept)
    assert not torch.equal(masks[0], masks[1])
    a = torch.from_numpy(ab_batch(3, px=64)["A"])
    e1 = pt.eval_step(st, a, "g")
    e2 = pt.eval_step(st, a, "g")
    assert torch.equal(e1, e2)
    gen_state = st.noise_generator.get_state()
    st.g.net.train()
    t1 = st.g.net(a)
    st.noise_generator.set_state(gen_state)
    t2 = st.g.net(a)
    assert torch.equal(t1, t2) and not torch.allclose(t1, e1)


def test_the_clis_train_and_serve_pix2pix(tmp_path):
    """The training CLI on ``options/i2i/train_pix2pix.yml`` at the
    narrow width above (``unaligned`` with ``serial_batches``, 4 steps,
    a sample grid every 2) and a resume to 6; then the test CLI serves G
    from a ``single`` dataset."""
    from test_torch_cyclegan_trainer import i2i_cli

    i2i_cli(tmp_path, "train_pix2pix.yml", {
        "network_G": {"type": "unet_net", "num_downs": 5, "ngf": 8,
                      "norm_type": "batch", "use_dropout": True},
        "network_D": {"type": "patchgan", "ndf": 8, "n_layers": 3}},
        ("G", "D"), "G")
    assert os.path.isdir(tmp_path)
