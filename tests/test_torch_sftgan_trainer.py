"""SFTGAN's trainer (``trainner_tpu_torch/train/sftgan_trainer.py``)
against the JAX ``SFTGANTrainer`` on the CPU, from one carried state: SFTNet
at nf 8, cond_nf 16, 2 blocks, the ACD discriminator at its only size (96
px, b=2), the template's losses (VGG19 feature L1 on seeded VGG weights
that both packages read, vanilla GAN 5e-3), sgd at lr 1e-2. Three steps
with the batch's ``category`` and three with it derived from the maps,
each from the JAX state of that step (nets, statistics, moments): every
log within 1e-4 relative, every G and D tensor within 1e-3 of its largest
update plus 2e-7 (``test_torch_pix2pix_trainer.check_tensors``: in L2
norm within 1e-2 where a ReLU-class branch flips, ROADMAP C 15).

ROADMAP C 22, held here: the trainer reads nf, cond_nf and n_blocks while
``_build_sft`` reads none of ``network_G``, and the SFT layers keep a hidden
width of 32 whatever cond_nf is; ``network_D: dis_acd`` is never read;
G's GAN term is scaled by ``gan_weight`` and its class cross-entropy is
not; D's loss is (real + fake) / 2 plus both cross-entropies, and D keeps
its real pass's batch statistics alone; the optimizers read no betas;
the labels are the argmax of the maps' mean without ``category``.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loss_stack import _vgg19_npz
from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from test_torch_unshuffle_step import _redraw
from trainner_tpu.train.sftgan_trainer import SFTGANTrainer as JaxTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.models.sft import ACDVGGBN96, SFTNet
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.sftgan_trainer import SFTGANTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)
BATCH, HR, STEPS = 2, 96, 3
OPTIONS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "options")


def options(vgg, **train):
    opt = {"name": "sft_steps", "model": "sftgan", "scale": 4,
           "datasets": {"train": {"name": "t", "mode": "LRHRseg_bg",
                                  "dataroot_HR": "/x", "crop_size": HR,
                                  "batch_size": BATCH}},
           "network_G": {"type": "sft_arch", "nf": 8, "cond_nf": 16,
                         "n_blocks": 2},
           "network_D": {"type": "dis_acd"},
           "path": {"root": "/tmp/sft_steps", "vgg_weights": vgg},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "beta1_G": 0.9, "pixel_weight": 0,
                     "pixel_criterion": "l1", "feature_criterion": "l1",
                     "feature_weight": 1, "gan_type": "vanilla",
                     "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50], **train}}
    return dict(parse_dict(opt, is_train=True))


def seg_batch(seed=0, category=True):
    rng = np.random.RandomState(seed)
    seg = rng.rand(BATCH, HR, HR, 8).astype(np.float32)
    seg /= seg.sum(-1, keepdims=True)
    out = {"LR": rng.rand(BATCH, HR // 4, HR // 4, 3).astype(np.float32),
           "HR": rng.rand(BATCH, HR, HR, 3).astype(np.float32), "seg": seg}
    if category:
        out["category"] = rng.randint(0, 8, BATCH).astype(np.int32)
    return out


def carried(jstate, pstate):
    """The JAX state (nets, D's statistics, both optimizers' moments) as
    the port's ``load_train_state`` takes it."""
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step),
        g_opt_state=_numpy(jstate.g.opt_state),
        d_opt_state=_numpy(jstate.d.opt_state),
        g_net=pstate.g.net, d_net=pstate.d.net)


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    return _vgg19_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")


@pytest.fixture(scope="module", params=["given", "derived"])
def run(request, vgg, tmp_path_factory):
    opt = options(vgg)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (BATCH, HR // 4, HR // 4,
                                                     3))
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 1.0)),
        d=template.d.replace(params=_redraw(template.d.params, 2, 1.0)))
    pt = SFTGANTrainer(copy.deepcopy(opt), dtype=torch.float32,
                       device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, carried(jstate, pstate))
    tmp = tmp_path_factory.mktemp("sft")
    steps = []
    for step in range(STEPS):
        batch = seg_batch(step, request.param == "given")
        # each step from the JAX state of that step
        load_train_state(pstate, carried(jstate, pstate))
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
            saved = {"g": sd(pstate.g.net), "d": sd(pstate.d.net)}
            C.save_state(pstate, str(tmp / "port.state"), epoch=0)
            JC.save_state(jstate, str(tmp / "jax.state"), epoch=0)
            C.save_params(C.train_state_to_jax(pstate)["g"]["params"],
                          str(tmp / "port_G.ckpt"))
            JC.save_params(jstate.g.params, str(tmp / "jax_G.ckpt"))
    return {"opt": opt, "jt": jt, "jstate": jstate, "template": template,
            "pt": pt, "pstate": pstate, "steps": steps, "tmp": tmp,
            "case": request.param, "saved": saved}


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_jax(run, step):
    rec = run["steps"][step]
    _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)
    assert {"l_g_fea", "l_g_gan", "l_g_cls", "l_d_cls",
            "l_d_total"} <= set(rec["logs"])
    for w in ("g", "d"):
        check_tensors(rec["after"][w], rec["want"][w], rec["before"][w],
                      step, w)


def test_d_keeps_its_real_pass_statistics(vgg):
    """After a step D's running statistics are those of its pass on HR,
    from its weights before the update; the G stage's and the fake pass
    leave none."""
    pt = SFTGANTrainer(options(vgg), dtype=torch.float32, device="cpu")
    st = pt.init_state(3)
    batch = {k: torch.from_numpy(v) for k, v in seg_batch(5).items()}
    d = ACDVGGBN96()
    d.load_state_dict(st.d.net.state_dict())
    d(batch["HR"], train=True)
    want = [m.pending for m in d.norms()]
    pt.train_step(st, batch)
    got = [(m.running_mean, m.running_var) for m in st.d.net.norms()]
    assert len(got) == 7
    for (gm, gv), (wm, wv) in zip(got, want):
        assert torch.equal(gm, wm) and torch.equal(gv, wv)


def test_the_trainer_reads_the_widths_define_g_does_not(vgg):
    """``define_G`` builds SFTNet at its defaults whatever ``network_G``
    says; the trainer builds nf 8, cond_nf 16, 2 blocks, with SFT layers
    of hidden width 32; D is the ACD one; Adam's betas are not read."""
    opt = options(vgg, optim_G="adam", beta1_G=0.1)
    g = define_G(opt)
    assert isinstance(g, SFTNet) and g.n_blocks == 16 and \
        g.conv0.weight.shape[0] == 64
    st = SFTGANTrainer(opt, dtype=torch.float32, device="cpu").init_state(0)
    net = st.g.net
    assert net.n_blocks == 2 and net.conv0.weight.shape[0] == 8
    assert net.cond4.weight.shape[0] == 16
    assert net.sft_final.scale0.weight.shape[:2] == (32, 16)
    assert isinstance(st.d.net, ACDVGGBN96)
    assert st.g.opt.beta1 == 0.9


@pytest.mark.parametrize("with_seg", [True, False])
def test_eval_step_matches_jax(run, with_seg):
    """G's output with the given maps, and with uniform 1/8 maps where
    none are given, against the JAX ``eval_step``."""
    b = seg_batch(9)
    seg = b["seg"] if with_seg else None
    want = np.asarray(run["jt"].eval_step(
        run["jstate"], jnp.asarray(b["LR"]),
        None if seg is None else jnp.asarray(seg)))
    pt = SFTGANTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                       device="cpu")
    st = pt.init_state(0)
    load_train_state(st, carried(run["jstate"], st))
    got = pt.eval_step(st, torch.from_numpy(b["LR"]),
                       None if seg is None else torch.from_numpy(seg))
    assert got.shape == (BATCH, HR, HR, 3)
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("source", ["port", "jax"])
def test_checkpoints_cross_both_packages(run, source):
    """Each package's ``.state`` of step 2 resumes the port (the port's
    own with the tensors it saved, bit for bit; the JAX one taking step 3
    with the JAX run's logs) and each ``_G.ckpt`` loads into the port's G;
    the JAX package loads the port's."""
    tmp = run["tmp"]
    pt = SFTGANTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                       device="cpu")
    st, meta = C.load_state(str(tmp / f"{source}.state"), pt.init_state(4))
    assert st.step == 2 == meta["iter"]
    if source == "port":
        for w in ("g", "d"):
            got = sd(getattr(st, w).net)
            assert all(np.array_equal(got[k], v)
                       for k, v in run["saved"][w].items())
    batch = seg_batch(2, run["case"] == "given")
    st, logs = pt.train_step(st, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    if source == "jax":
        _check_logs({k: float(v) for k, v in logs.items()},
                    run["steps"][2]["jlogs"], 1e-4, 2)
    g = pt.init_state(0, g_path=str(tmp / f"{source}_G.ckpt")).g.net
    other = "jax" if source == "port" else "port"
    g2 = pt.init_state(0, g_path=str(tmp / f"{other}_G.ckpt")).g.net
    for k, v in g.state_dict().items():
        assert torch.allclose(v, g2.state_dict()[k], atol=1e-4), k
    if source == "port":
        loaded, meta = JC.load_state(str(tmp / "port.state"),
                                     run["template"])
        assert int(loaded.step) == 2
        JC.load_params(str(tmp / "port_G.ckpt"), run["template"].g.params)


def write_seg_corpus(root, n=3, px=128, seed=0):
    """Seeded HR PNGs and their (h, w, 8) probability maps as ``.npy``
    files of the same stem: ``root/hr``, ``root/seg``."""
    from trainner_tpu_torch.data.common import save_img

    rng = np.random.RandomState(seed)
    for d in ("hr", "seg"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        save_img((rng.rand(px, px, 3) * 255).astype(np.uint8),
                 os.path.join(root, "hr", f"img{i}.png"))
        seg = rng.rand(px, px, 8).astype(np.float32)
        np.save(os.path.join(root, "seg", f"img{i}.npy"),
                seg / seg.sum(-1, keepdims=True))
    return os.path.join(root, "hr"), os.path.join(root, "seg")


def test_the_clis_train_and_serve_sftgan(tmp_path, vgg):
    """``options/sr/train_sftgan.json`` at the narrow width above (b=2,
    crop 96), 4 iterations with a validation and a resume to 6; then the
    test CLI serves the G with a ``seg`` dataset's maps."""
    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data.common import read_png
    from trainner_tpu_torch.options.config import load_file
    from trainner_tpu_torch.train import main

    hr, seg = write_seg_corpus(str(tmp_path / "data"))
    opt = load_file(os.path.join(OPTIONS_DIR, "sr", "train_sftgan.json"))
    opt["name"] = "sft_cli"
    opt["network_G"] = {"type": "sft_arch", "nf": 8, "n_blocks": 2}
    opt["datasets"]["train"].update(dataroot_HR=hr, dataroot_seg=seg,
                                    batch_size=2, n_workers=1)
    opt["datasets"]["val"].update(dataroot_HR=hr, dataroot_seg=seg)
    opt["train"].update(niter=4, val_freq=4)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2}
    opt["path"] = {"root": str(tmp_path / "root"), "vgg_weights": vgg}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(opt))
    assert main(["-opt", str(path)], device="cpu").step == 4
    exp = tmp_path / "root" / "experiments" / "sft_cli"
    for it in (2, 4):
        for n in ("G", "D"):
            assert (exp / "models" / f"{it}_{n}.ckpt").exists()
    assert (exp / "val_images" / "img0" / "img0_4.png").exists()
    opt["train"]["niter"] = 6
    opt["path"]["resume_state"] = str(exp / "training_state")
    path.write_text(json.dumps(opt))
    assert main(["-opt", str(path)], device="cpu").step == 6
    serve = {"name": "serve", "model": "sftgan", "scale": 4,
             "network_G": opt["network_G"],
             "datasets": {"test_1": {"name": "s", "mode": "LRHRseg_bg",
                                     "dataroot_HR": hr,
                                     "dataroot_seg": seg}},
             "path": {"root": str(tmp_path / "serve"),
                      "pretrain_model_G": str(exp / "models" / "6_G.ckpt")}}
    spath = tmp_path / "serve.json"
    spath.write_text(json.dumps(serve))
    avg = test_cli.main(["-opt", str(spath)], device="cpu")
    assert np.isfinite([m["average"] for m in avg["s"]]).all()
    outs = sorted((tmp_path / "serve").rglob("img*.png"))
    assert len(outs) == 3 and read_png(str(outs[0])).shape == (128, 128, 3)
