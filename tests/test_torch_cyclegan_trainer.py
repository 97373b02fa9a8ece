"""CycleGAN's trainer (``trainner_tpu_torch/train/cyclegan_trainer.py``)
and its replay pools (``utils/image_pool.py``) against the JAX
``CycleGANTrainer`` on the CPU, from one carried state, at a narrow width:
the ResNet generator (ngf 8, 2 blocks, instance norm) with an
instance-norm PatchGAN (ndf 8, 3 layers), and the U-Net (num_downs 5, ngf
8, batch norm) with a batch-norm PatchGAN; 32 px, b=2, sgd at lr 1e-2,
lsgan, lambda_A = lambda_B = 10, identity 0.5, pools of 2 (so that the
pools swap from the second step on). Three steps: every log within 1e-4
relative, every tensor of both Gs and both Ds within 1e-3 of its largest
update plus 2e-7 (as ``test_three_steps_match_jax`` says); the pools'
choices are JAX's.

ROADMAP C 22, held here: ``gan_weight: 0`` counts as 1; the identity
terms cross lambda_B and lambda_A; G_B's batch statistics come from its
G_B(G_A(A)) pass; both pools share seed 0; a resume starts with empty
pools; the D loss is halved. The JAX test CLI cannot load a
``{tag}_G_A.ckpt`` into its ``{G_A, G_B}`` template; the port's loads it
into G_A.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.train.cyclegan_trainer import \
    CycleGANTrainer as JaxTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu.utils.image_pool import ImagePool as JaxPool
from trainner_tpu_torch.options.config import parse_dict, read_yaml
from trainner_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.image_pool import ImagePool
from trainner_tpu_torch.utils.torch_interop import (cyclegan_state_from_jax,
                                                    load_train_state,
                                                    train_state_to_jax)

torch.set_num_threads(2)
BATCH, PX, STEPS = 2, 32, 3
OPTIONS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "options")
NETS = {
    "resnet": ({"type": "resnet_net", "n_blocks": 2, "ngf": 8,
                "norm_type": "instance"},
               {"type": "patchgan", "ndf": 8, "n_layers": 3,
                "norm_type": "instance"}),
    "unet": ({"type": "unet_net", "num_downs": 5, "ngf": 8,
              "norm_type": "batch"},
             {"type": "patchgan", "ndf": 8, "n_layers": 3}),
}


def options(kind="resnet", **train):
    g, d = NETS[kind]
    opt = {"name": "cyc_steps", "model": "cyclegan", "scale": 1,
           "pool_size": 2,
           "datasets": {"train": {"name": "t", "mode": "unaligned",
                                  "dataroot_A": "/x", "dataroot_B": "/y",
                                  "crop_size": PX, "batch_size": BATCH,
                                  "znorm": True}},
           "network_G": dict(g), "network_D": dict(d),
           "path": {"root": "/tmp/cyc_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "gan_type": "lsgan",
                     "gan_weight": 1.0, "lambda_A": 10.0, "lambda_B": 10.0,
                     "lambda_identity": 0.5, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50], **train}}
    return dict(parse_dict(opt, is_train=True))


def ab_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {k: (rng.rand(BATCH, PX, PX, 3) * 2 - 1).astype(np.float32)
            for k in ("A", "B")}


def _tree(jstate):
    return _numpy(serialization.to_state_dict(jstate))


def _nets(pstate):
    out = {f"g.{k}": v for k, v in sd(pstate.g.net).items()}
    for w in ("d_a", "d_b"):
        out.update({f"{w}.{k}": v for k, v in
                    sd(getattr(pstate, w).net).items()})
    return out


def _carried_nets(carried):
    out = {f"g.{k}": v.numpy() for k, v in carried["g"].items()}
    for w in ("d_a", "d_b"):
        out.update({f"{w}.{k}": v.numpy() for k, v in carried[w].items()})
    return out


@pytest.fixture(scope="module", params=["unet", "resnet"])
def run(request, tmp_path_factory):
    opt = options(request.param)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (BATCH, PX, PX, 3))
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 1.0)),
        d_a=template.d_a.replace(params=_redraw(template.d_a.params, 2,
                                                1.0)),
        d_b=template.d_b.replace(params=_redraw(template.d_b.params, 3,
                                                1.0)))
    pt = CycleGANTrainer(copy.deepcopy(opt), dtype=torch.float32,
                         device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, cyclegan_state_from_jax(_tree(jstate), pstate))
    tmp = tmp_path_factory.mktemp("cyc")
    steps = []
    fresh = CycleGANTrainer(copy.deepcopy(opt), dtype=torch.float32,
                            device="cpu")
    fstate = fresh.init_state(0)
    for step in range(STEPS):
        batch = ab_batch(step)
        before = _nets(pstate)
        # the port's step from the JAX state of this step (its own pools,
        # which make the same choices)
        load_train_state(fstate, cyclegan_state_from_jax(_tree(jstate),
                                                         fstate))
        fbefore = _nets(fstate)
        fstate, flogs = fresh.train_step(
            fstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        steps.append({
            "logs": {k: float(v) for k, v in logs.items()},
            "fresh_logs": {k: float(v) for k, v in flogs.items()},
            "fresh_before": fbefore, "fresh_after": _nets(fstate),
            "jlogs": {k: float(v) for k, v in jlogs.items()},
            "before": before, "after": _nets(pstate),
            "want": _carried_nets(cyclegan_state_from_jax(_tree(jstate),
                                                          pstate))})
        if step == 1:
            C.save_checkpoint(pstate, {"path": {
                "models": str(tmp / "port_models"),
                "training_state": str(tmp / "port_state")}}, 0, 2)
            JC.save_checkpoint(jstate, {"path": {
                "models": str(tmp / "jax_models"),
                "training_state": str(tmp / "jax_state")}}, 0, 2)
    return {"opt": opt, "jt": jt, "jstate": jstate, "template": template,
            "pt": pt, "pstate": pstate, "steps": steps, "tmp": tmp,
            "kind": request.param, "fresh": fresh}


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_jax(run, step):
    """Each step of the port from the JAX state of that step (nets,
    moments; its own pools, which make the same choices): logs within
    1e-4, every tensor within 1e-3 of its largest update
    (``test_torch_pix2pix_trainer.check_tensors``: in L2 norm within 1e-2
    where a ReLU-class branch flips; the ResNet pair's instance norms put
    values of unit spread at every kink, ROADMAP C 15). The U-Net pair
    also runs its three steps unbroken, and its logs and tensors after
    each hold to the JAX run's as they stand."""
    rec = run["steps"][step]
    assert set(rec["logs"]) == {"l_cycle", "l_idt", "l_g_gan_A",
                                "l_g_gan_B", "l_g_total", "l_d_A", "l_d_B"}
    _check_logs(rec["fresh_logs"], rec["jlogs"], 1e-4, step)
    check_tensors(rec["fresh_after"], rec["want"], rec["fresh_before"], step,
                  "all")
    if run["kind"] == "unet":
        _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)
        check_tensors(rec["after"], rec["want"], rec["before"], step, "all")


def test_the_pools_make_the_jax_choices(run):
    """After the run both pools hold what the JAX ones hold and their
    generators stand where JAX's do (for the ResNet pair, the pools of
    the port's steps from each step's JAX state)."""
    port = run["pt"] if run["kind"] == "unet" else run["fresh"]
    for name in ("fake_a_pool", "fake_b_pool"):
        got, want = getattr(port, name), getattr(run["jt"], name)
        assert got.count == len(want.images) == 2
        np.testing.assert_allclose(got.images.numpy(), np.stack(want.images),
                                   atol=1e-4)
        assert got.rng.random() == want.rng.random()


def test_image_pool_on_its_own():
    """The pool against the JAX one on the same images, batch by batch:
    the same images out, the same images kept; nothing leaves the
    batch's device, and the input batch is left as it was."""
    got, want = ImagePool(3), JaxPool(3)
    rng = np.random.RandomState(0)
    for _ in range(6):
        x = rng.rand(2, 4, 4, 3).astype(np.float32)
        t = torch.from_numpy(x.copy())
        out = got.query(t)
        assert np.array_equal(out.numpy(), want.query(x))
        assert np.array_equal(t.numpy(), x)
    assert np.array_equal(got.images.numpy(), np.stack(want.images))
    assert ImagePool(0).query(t) is t


def test_gan_weight_zero_counts_as_one():
    opt = options(gan_weight=0)
    pt = CycleGANTrainer(opt, dtype=torch.float32, device="cpu")
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    assert pt.use_gan and jt.use_gan and pt.gan_weight == jt.gan_weight == 1
    st = pt.init_state(0)
    assert st.d_a is not None and st.d_b is not None


def test_checkpoints_cross_both_packages(run):
    """Both packages write ``2_G_A``, ``2_G_B``, ``2_D_A``, ``2_D_B`` and
    ``2.state``; each loads the other's: the JAX package the port's four
    nets and state, the port the JAX state (resuming to the step the
    unbroken run took) and the JAX ``G_A`` file."""
    tmp = run["tmp"]
    names = {f"2_{n}.ckpt" for n in ("G_A", "G_B", "D_A", "D_B")}
    assert names <= set(os.listdir(tmp / "port_models"))
    assert names <= set(os.listdir(tmp / "jax_models"))
    tmpl = run["template"]
    for n, leaf in (("G_A", tmpl.g.params["G_A"]),
                    ("G_B", tmpl.g.params["G_B"]), ("D_A", tmpl.d_a.params),
                    ("D_B", tmpl.d_b.params)):
        ours = JC.load_params(str(tmp / "port_models" / f"2_{n}.ckpt"), leaf)
        theirs = JC.load_params(str(tmp / "jax_models" / f"2_{n}.ckpt"),
                                leaf)
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(theirs)
        if run["kind"] == "unet":  # the ResNet pair's runs part (above)
            for a, b in zip(jax.tree_util.tree_leaves(ours),
                            jax.tree_util.tree_leaves(theirs)):
                assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-4
    loaded, meta = JC.load_state(str(tmp / "port_state" / "2.state"), tmpl)
    assert int(loaded.step) == 2 == meta["iter"]
    pt = CycleGANTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                         device="cpu")
    st, meta = C.load_state(str(tmp / "jax_state" / "2.state"),
                            pt.init_state(5))
    assert st.step == 2 and pt.fake_a_pool.count == 0
    st, logs = pt.train_step(
        st, {k: torch.from_numpy(v) for k, v in ab_batch(2).items()})
    # a resume starts with empty pools: the G stage is the unbroken run's
    for k in ("l_cycle", "l_idt", "l_g_gan_A", "l_g_gan_B", "l_g_total"):
        assert abs(float(logs[k]) - run["steps"][2]["jlogs"][k]) <= \
            1e-4 * max(abs(run["steps"][2]["jlogs"][k]), 1e-3)
    tree = train_state_to_jax(st)
    assert set(tree) == {"step", "rng", "g", "d_a", "d_b"}
    from trainner_tpu_torch.train.cyclegan_trainer import _load_g
    from trainner_tpu_torch.utils.torch_interop import g_from_jax

    path = str(tmp / "jax_models" / "2_G_A.ckpt")
    g = pt.init_state(9).g.net
    _load_g(g, path)
    want = g_from_jax(_numpy(JC.load_params(path)), None, g["G_A"])
    got = g["G_A"].state_dict()
    assert want and all(torch.equal(got[k], v) for k, v in want.items())


def test_eval_step_serves_g_a(run):
    """G_A in eval mode against the JAX ``eval_step``, from the JAX
    state."""
    x = ab_batch(7)["A"]
    want = np.asarray(run["jt"].eval_step(run["jstate"], jnp.asarray(x)))
    pt = CycleGANTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                         device="cpu")
    st = pt.init_state(0)
    load_train_state(st, cyclegan_state_from_jax(_tree(run["jstate"]), st))
    got = pt.eval_step(st, torch.from_numpy(x), "g").numpy()
    assert np.abs(got - want).max() < 1e-5


def write_ab(root, n=3, px=64, seed=0):
    """Seeded PNG folders ``A`` and ``B`` of ``n`` images each."""
    from trainner_tpu_torch.data.common import save_img

    rng = np.random.RandomState(seed)
    for side in ("A", "B"):
        os.makedirs(os.path.join(root, side), exist_ok=True)
        for i in range(n):
            save_img((rng.rand(px, px, 3) * 255).astype(np.uint8),
                     os.path.join(root, side, f"{side}{i}.png"))
    return os.path.join(root, "A"), os.path.join(root, "B")


def i2i_cli(tmp, yml, nets, files, serve):
    """The training CLI on ``options/i2i/{yml}`` with ``nets`` replacing
    its networks, seeded A/B folders, b=2, crop 32, 4 iterations with a
    sample grid every 2 and checkpoints at 2 and 4, then a resume to 6;
    the test CLI serves ``6_{serve}.ckpt`` from a ``single`` dataset of
    A. Returns the experiment directory."""
    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data.common import read_png
    from trainner_tpu_torch.train import main

    a, b = write_ab(str(tmp / "data"))
    opt = read_yaml(os.path.join(OPTIONS_DIR, "i2i", yml))
    opt.update(nets)
    opt["datasets"]["train"].update(dataroot_A=a, dataroot_B=b,
                                    batch_size=2, crop_size=32,
                                    serial_batches=True, n_workers=1)
    opt["train"]["niter"] = 4
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2,
                     "display_freq": 2}
    opt["path"] = {"root": str(tmp / "root")}
    path = tmp / "train.json"
    path.write_text(json.dumps(opt))
    state = main(["-opt", str(path)], device="cpu")
    assert state.step == 4
    exp = tmp / "root" / "experiments" / opt["name"]
    for it in (2, 4):
        grid = read_png(str(exp / "samples" / f"{it:08d}.png"))
        assert grid.shape == (32, 96, 3)
        for n in files:
            assert (exp / "models" / f"{it}_{n}.ckpt").exists()
    opt["train"]["niter"] = 6
    opt["path"]["resume_state"] = str(exp / "training_state")
    path.write_text(json.dumps(opt))
    state = main(["-opt", str(path)], device="cpu")
    assert state.step == 6
    serve_opt = {"name": "serve", "model": opt["model"], "scale": 1,
                 "datasets": {"test_1": {"name": "a", "mode": "single",
                                         "dataroot_LR": a}},
                 "network_G": opt["network_G"],
                 "path": {"root": str(tmp / "serve"),
                          "pretrain_model_G": str(
                              exp / "models" / f"6_{serve}.ckpt")}}
    spath = tmp / "serve.json"
    spath.write_text(json.dumps(serve_opt))
    test_cli.main(["-opt", str(spath)], device="cpu")
    outs = sorted((tmp / "serve").rglob("A*.png"))
    assert len(outs) == 3
    assert read_png(str(outs[0])).shape == (64, 64, 3)
    return exp


def test_the_clis_train_and_serve_cyclegan(tmp_path):
    """``options/i2i/train_cyclegan.yml`` at the narrow width above:
    its four net files at each save, the grids, a resume, and G_A served
    from its ``6_G_A.ckpt``."""
    g, d = NETS["resnet"]
    i2i_cli(tmp_path, "train_cyclegan.yml",
            {"network_G": g, "network_D": d},
            ("G_A", "G_B", "D_A", "D_B"), "G_A")
