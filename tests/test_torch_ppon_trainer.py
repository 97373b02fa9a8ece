"""PPON's three-phase trainer (``trainner_tpu_torch/train/ppon_trainer.py``)
against the JAX ``PPONTrainer`` on the CPU, from one carried state and the
same batch, at a narrow width (nf 8, nb 1, D-VGG nf 8, HR 32).

With ``ppon_stages: [1, 2]`` four steps run phase 1 (``pix``), phase 2
(the defaults: ``pix-multiscale`` and ``ms-ssim``) and phase 3 twice
(``pix`` with the GAN, D updated). sgd at lr 1e-2 (as
``test_torch_unshuffle_step.py``): every log within 1e-4 relative, every
G and D tensor within 1e-3 of its largest update plus 2e-7, and the
branches outside the phase bit-equal across the step. Then: a resume from
the port's ``.state`` and from the JAX one lands in phase 3, where the
run was; each file loads in the other package; ``eval_step`` serves the
output of ``ppon_phase`` (plain and x8) as the JAX one does; and both CLIs
of the port run ``model: ppon``.
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
from trainner_tpu.train.ppon_trainer import PPONTrainer as JaxPPONTrainer
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.ppon_trainer import (PHASE_PREFIXES,
                                                   PPONTrainer, phase_params)
from trainner_tpu_torch.train.sr_trainer import create_trainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    train_state_from_jax,
                                                    train_state_to_jax)

torch.set_num_threads(2)
BATCH, LR_PX, SCALE = 2, 8, 4
PHASES = [1, 2, 3, 3]


def _options():
    opt = {"name": "ppon_steps", "model": "ppon", "scale": SCALE,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x", "crop_size": 32,
                                  "batch_size": BATCH}},
           "network_G": {"type": "ppon", "nf": 8, "nb": 1},
           "network_D": {"type": "discriminator_vgg", "nf": 8},
           "path": {"root": "/tmp/ppon_steps"},
           "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                     "optim_D": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "ssim_type": "ms-ssim",
                     "ssim_weight": 1.0, "ms_criterion": "multiscale-l1",
                     "ms_weight": 1.0, "gan_type": "vanilla",
                     "gan_weight": 5e-3, "p3_losses": ["pix"],
                     "ppon_stages": [1, 2], "lr_scheme": "MultiStepLR",
                     "lr_steps": [50]}}
    return dict(parse_dict(opt, is_train=True))


def _batch():
    rng = np.random.RandomState(0)
    return {"LR": rng.rand(BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(BATCH, LR_PX * SCALE, LR_PX * SCALE,
                           3).astype(np.float32)}


def _carried(jstate, g_net):
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step), g_net=g_net)


def _sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Four steps of each trainer from one state; the port's and the JAX
    ``.state`` after two of them."""
    opt = _options()
    jt = JaxPPONTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0),
                             (BATCH, LR_PX, LR_PX, 3),
                             (BATCH, LR_PX * SCALE, LR_PX * SCALE, 3))
    jstate = template.replace(
        g=template.g.replace(params=_redraw(template.g.params, 1, 0.7)),
        d=template.d.replace(params=_redraw(template.d.params, 2, 1.0)))
    pt = PPONTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, _carried(jstate, pstate.g.net))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmp = tmp_path_factory.mktemp("ppon")
    steps = []
    carried = _carried(jstate, pstate.g.net)
    for step in range(len(PHASES)):
        before = {"g": _sd(pstate.g.net), "d": _sd(pstate.d.net)}
        jbefore = {w: {k: v.numpy() for k, v in carried[w].items()}
                   for w in ("g", "d")}
        jstate, jlogs = jt.train_step(jstate, jbatch)
        pstate, logs = pt.train_step(pstate, tbatch)
        carried = _carried(jstate, pstate.g.net)
        steps.append({
            "logs": {k: float(v) for k, v in logs.items()},
            "jlogs": {k: float(v) for k, v in jlogs.items()},
            "before": before, "jbefore": jbefore,
            "after": {"g": _sd(pstate.g.net), "d": _sd(pstate.d.net)},
            "want": {w: {k: v.numpy() for k, v in carried[w].items()}
                     for w in ("g", "d")}})
        if step == 1:
            C.save_state(pstate, str(tmp / "port.state"), epoch=0)
            JC.save_state(jstate, str(tmp / "jax.state"), epoch=0)
    return {"opt": opt, "jt": jt, "jstate": jstate, "template": template,
            "pt": pt, "pstate": pstate, "steps": steps, "tmp": tmp,
            "tbatch": tbatch}


def test_phase_prefixes_cover_g_once():
    """Every parameter of PPON lies in exactly one phase's branch."""
    opt = _options()
    net = PPONTrainer(opt, dtype=torch.float32, device="cpu") \
        .init_state(0).g.net
    names = [n for n, _ in net.named_parameters()]
    owners = [[ph for ph, pre in PHASE_PREFIXES.items() if n.startswith(pre)]
              for n in names]
    assert all(len(o) == 1 for o in owners)
    for ph in (1, 2, 3):
        live, frozen = phase_params(net, ph)
        assert len(live) + len(frozen) == len(names) and live


@pytest.mark.parametrize("step", range(len(PHASES)))
def test_step_of_each_phase_matches_jax(run, step):
    rec = run["steps"][step]
    _check_logs(rec["logs"], rec["jlogs"], 1e-4, step)
    phase = PHASES[step]
    assert rec["logs"]["ppon_phase"] == phase
    assert ("l_d_total" in rec["logs"]) == (phase == 3)
    prefixes = PHASE_PREFIXES[phase]
    for which in ("g", "d"):
        got, want, old, jold = (rec["after"][which], rec["want"][which],
                                rec["before"][which], rec["jbefore"][which])
        assert set(got) == set(want)
        for k, w in want.items():
            if (which == "g" and not k.startswith(prefixes)) or \
                    (which == "d" and phase != 3):
                # a frozen branch (and D outside phase 3) comes back bit
                # for bit, in both packages
                assert np.array_equal(got[k], old[k]), (step, which, k)
                assert np.array_equal(w, jold[k]), (step, which, k)
                continue
            moved = np.abs(w - old[k]).max()
            err = np.abs(got[k] - w).max()
            assert err <= 1e-3 * moved + 2e-7, (step, which, k, err, moved)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_a_resume_lands_in_the_phase_of_its_step(run, source):
    """A new port trainer resumed from the ``.state`` of step 2 (written by
    the port or by the JAX package) runs phase 3 with the logs that the
    unbroken run took at that step."""
    pt = PPONTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                     device="cpu")
    pstate = pt.init_state(7)
    pstate, meta = C.load_state(str(run["tmp"] / f"{source}.state"), pstate)
    assert pstate.step == 2 == meta["iter"]
    assert pt.current_phase(pstate.step) == 3
    pstate, logs = pt.train_step(pstate, run["tbatch"])
    _check_logs({k: float(v) for k, v in logs.items()},
                run["steps"][2]["jlogs"], 1e-4, 2)
    assert pstate.step == 3


def test_the_port_state_loads_in_jax(run):
    loaded, meta = JC.load_state(str(run["tmp"] / "port.state"),
                                 run["template"])
    assert meta["iter"] == 2 and int(loaded.step) == 2
    got = serialization.to_state_dict(loaded)

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}/"))
            else:
                out[pre + k] = v
        return out

    pstate = PPONTrainer(copy.deepcopy(run["opt"]), dtype=torch.float32,
                         device="cpu").init_state(0)
    C.load_state(str(run["tmp"] / "port.state"), pstate)
    want = flat(train_state_to_jax(pstate))
    got = flat(got)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


@pytest.mark.parametrize("phase", [1, 2, 3])
def test_eval_step_serves_the_output_of_ppon_phase(run, phase):
    lr = np.random.RandomState(3).rand(1, 6, 10, 3).astype(np.float32)
    jt, pt = run["jt"], run["pt"]
    jt.inference_phase = pt.inference_phase = phase
    try:
        want = np.asarray(jt.eval_step(run["jstate"], jnp.asarray(lr)))
        got = pt.eval_step(run["pstate"], torch.from_numpy(lr)).numpy()
        assert got.shape == want.shape == (1, 24, 40, 3)
        assert np.abs(got - want).max() < 1e-5
        if phase == 1:
            want = np.asarray(jt.eval_step_x8(run["jstate"],
                                              jnp.asarray(lr)))
            got = pt.eval_step_x8(run["pstate"],
                                  torch.from_numpy(lr)).numpy()
            assert np.abs(got - want).max() < 1e-5
    finally:
        jt.inference_phase = pt.inference_phase = 3


def test_create_trainer_builds_ppon_and_the_phases_of_the_counter():
    opt = _options()
    trainer = create_trainer(opt, device="cpu")
    assert isinstance(trainer, PPONTrainer)
    assert trainer.dtype == torch.bfloat16
    assert [trainer.current_phase(s) for s in (0, 1, 2, 50)] == [1, 2, 3, 3]
    assert not trainer.can_scan_steps()


def _cli_options(tmp_path, niter, resume=None):
    text = f"""name: ppon_cli
model: ppon
scale: 4
use_amp: false
datasets:
  train:
    name: synth_train
    mode: synthetic
    n_samples: 4
    crop_size: 32
    batch_size: 2
    n_workers: 1
  val:
    name: synth_val
    mode: synthetic
    n_samples: 1
    crop_size: 32
network_G:
  type: ppon
  nf: 8
  nb: 1
network_D:
  type: discriminator_vgg
  nf: 8
path:
  root: {tmp_path / 'root'}
{f'  resume_state: {resume}' if resume else ''}
train:
  lr_G: 1e-4
  lr_D: 1e-4
  lr_scheme: MultiStepLR
  lr_steps: [100]
  niter: {niter}
  pixel_criterion: l1
  pixel_weight: 1
  gan_type: vanilla
  gan_weight: 5e-3
  p2_losses: [pix]
  p3_losses: [pix]
  ppon_stages: [1, 2]
logger:
  print_freq: 1
  save_checkpoint_freq: 2
  tensorboard: true
"""
    path = tmp_path / f"ppon_{niter}.yml"
    path.write_text(text)
    return str(path)


def test_both_cli_run_ppon_on_the_cpu(tmp_path):
    """The training CLI through the three phases (the scalars carry
    ``ppon_phase``), a resume that continues in phase 3, then the test CLI
    on the saved G with ``ppon_phase`` 1 and x8, and with ``ppon_phase``
    3: the PNGs differ, each of the LR's size times 4."""
    import json

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data.common import read_png, save_img, \
        tensor2img
    from trainner_tpu_torch.train import main
    from trainner_tpu_torch.utils.torch_interop import g_to_jax

    state = main(["-opt", _cli_options(tmp_path, 2)], device="cpu")
    assert state.step == 2
    exp = tmp_path / "root" / "experiments" / "ppon_cli"
    state = main(["-opt", _cli_options(
        tmp_path, 4, exp / "training_state" / "2.state")], device="cpu")
    assert state.step == 4
    # both runs append their scalars to one JSONL (the text logs of two
    # runs that start in the same second share a file name)
    rows = [json.loads(line) for line in
            (exp / "tb" / "scalars.jsonl").read_text().splitlines()]
    phases = {r["step"]: r["value"] for r in rows
              if r["tag"] == "train/ppon_phase"}
    assert phases == {1: 1.0, 2: 2.0, 3: 3.0, 4: 3.0}
    assert {r["step"] for r in rows if r["tag"] == "train/l_d_total"} \
        == {3, 4}
    # a G of larger weights than the run's (Kaiming x 0.1 leaves PPON's
    # output near zero), so that the phases' outputs differ in 8 bits
    net = PPONTrainer(_options(), dtype=torch.float32,
                      device="cpu").init_state(0).g.net
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for prm in net.parameters():
            prm.normal_(0.0, 0.15, generator=gen)
    g_path = str(tmp_path / "big_G.ckpt")
    C.save_params(g_to_jax(net.state_dict(), net)[0], g_path)
    lr_img = (np.random.RandomState(0).rand(6, 9, 3) * 255).astype(np.uint8)
    lr_dir = tmp_path / "lr"
    save_img(lr_img, str(lr_dir / "a.png"))
    x = torch.from_numpy(lr_img[None].astype(np.float32) / 255.0)
    outs = {}
    for phase, x8 in ((1, True), (3, False)):
        opt = {"name": f"ppon_test_{phase}", "model": "ppon", "scale": 4,
               "is_train": False, "ppon_phase": phase, "x8": x8,
               "network_G": {"type": "ppon", "nf": 8, "nb": 1},
               "datasets": {"test": {"name": "t", "mode": "LR",
                                     "dataroot_LR": str(lr_dir)}},
               "path": {"root": str(tmp_path / f"test_{phase}"),
                        "pretrain_model_G": g_path}}
        path = tmp_path / f"test_{phase}.json"
        path.write_text(json.dumps(opt))
        test_cli.main(["-opt", str(path)], device="cpu")
        png = next((tmp_path / f"test_{phase}").rglob("a.png"))
        outs[phase] = read_png(str(png))
        trainer = PPONTrainer({**parse_dict(opt, is_train=False)},
                              dtype=torch.float32, device="cpu")
        state = trainer.init_state(0, g_path)
        with torch.no_grad():
            y = (trainer.eval_step_x8 if x8 else trainer.eval_step)(state, x)
        assert np.abs(outs[phase].astype(int)
                      - tensor2img(y[0]).astype(int)).max() <= 1
        assert outs[phase].shape == (24, 36, 3)
    assert np.abs(outs[1].astype(int) - outs[3].astype(int)).max() > 8
    assert os.path.exists(exp / "models" / "4_D.ckpt")
