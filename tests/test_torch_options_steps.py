"""Three trainer steps per option of the port's ``SRTrainer`` against the
JAX package's on the CPU (the harness of ``test_torch_trainer_options.py``:
one carried state, the port on JAX's draws): every optimizer for G and D,
``grad_clip: auto`` (D clipped to G's history, a step without a G update
between), a virtual batch (and its equality with one full-batch step),
FreezeD, frequency separation, SWA with its rate's switch-over; then the
training state with each of these parts saved by either package and
loaded by the other, and the training CLI with them and a resume, whose
``_swaG`` file the test CLI serves with ``which: swa``.
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_trainer_options import (batches, carried, options, pair,
                                        run)
from test_torch_train_step import _numpy
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch import test as test_cli
from trainner_tpu_torch.train import main
from trainner_tpu_torch.train.sr_trainer import SRTrainer, d_flax_names
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.logging_utils import close_logger

torch.set_num_threads(2)


def _nets(state) -> dict:
    return {w: {k: v.detach().numpy().copy() for k, v in
                getattr(state, w).net.state_dict().items()}
            for w in ("g", "d")}


def _jax_nets(jstate) -> dict:
    c = carried(jstate)
    return {w: {k: v.numpy() for k, v in c[w].items()} for w in ("g", "d")}


def _params_close(pstate, jstate, before, tol_of_move):
    """Every parameter of G and D within ``tol_of_move(moved)`` of the JAX
    one, moved being how far the JAX tensor went over the steps; D's
    biases whose gradient is rounding alone (a conv's that a batch norm
    follows, the dense layers', as ``test_torch_train_step.py`` names
    them) within 1e-6."""
    got, want = _nets(pstate), _jax_nets(jstate)
    for w in ("g", "d"):
        for k, v in want[w].items():
            if "running_" in k:
                continue
            moved = np.abs(v - before[w][k]).max()
            err = np.abs(got[w][k] - v).max()
            noise_only = w == "d" and k.endswith("bias") and (
                k.startswith("linear")
                or k.replace("bias", "norm.weight") in want[w])
            tol = max(tol_of_move(moved), 1e-6) if noise_only \
                else tol_of_move(moved)
            assert err <= tol, (w, k, err, moved)


@pytest.mark.parametrize("optim,wd", [
    ("rmsprop", 0.0), ("rmsprop", 1e-2), ("adamp", 0.0), ("adamp", 1e-2),
    ("sgdp", 1e-2), ("ranger", 0.0), ("madgrad", 0.0), ("madgrad", 1e-2)])
def test_optimizer_steps_match_jax(optim, wd):
    """G and D under each rule, with and without weight decay, three steps
    with ``D_update_ratio: 2`` (step 1 updates D alone); the logs as
    above; the parameters within 2 lr per step of JAX's (an element whose
    gradient is rounding may move a whole lr the other way) and SGDP's
    within 1e-3 of each tensor's move."""
    lr = 1e-2 if optim == "sgdp" else 1e-4
    opt = options(optim, lr, D_update_ratio=2, weight_decay_G=wd,
                  weight_decay_D=wd)
    jt, jstate, pt, pstate = pair(opt)
    before = _jax_nets(jstate)
    _, jstate, _, pstate = run(opt, 3)
    if optim == "sgdp":
        _params_close(pstate, jstate, before,
                      lambda moved: 1e-3 * moved + 2e-7)
    else:
        _params_close(pstate, jstate, before, lambda moved: 2 * lr * 3)


def test_auto_clip_steps_match_jax():
    """``grad_clip: auto`` with ``D_update_ratio: 2``: G clipped to the
    10th percentile of its norm history, D to that history after G's
    update, and on step 1 (no G update) to the history as it was. The
    logs, and the history's count and values within 1e-5 of JAX's."""
    opt = options(grad_clip="auto", D_update_ratio=2)
    _, jstate, _, pstate = run(opt, 3)
    hist = _numpy(jstate.grad_hist)
    assert int(pstate.grad_hist["n"]) == int(hist["n"]) == 2
    np.testing.assert_allclose(pstate.grad_hist["vals"].numpy(),
                               hist["vals"], rtol=1e-5)


@pytest.mark.parametrize("accum", [2, 4])
def test_virtual_batch_steps_match_jax(accum):
    """A microbatches per step (batch 4): the gradients summed over them
    and divided by A, the logs averaged, D's statistics from the last."""
    run(options(virtual_batch_size=accum), 3)


def test_virtual_batch_equals_one_full_batch_step():
    """Pixel loss alone (no batch statistics): two microbatches of 2 give
    G's parameters within 5e-6 of one step on the batch of 4, as the JAX
    package's test holds its own."""
    opt = options(gan_weight=0)
    opt["train"].pop("gan_type")
    b = {k: torch.from_numpy(v) for k, v in batches(1)[0].items()}
    states = []
    for accum in (1, 2):
        o = copy.deepcopy(opt)
        o["train"]["virtual_batch_size"] = accum
        tr = SRTrainer(o, dtype=torch.float32, device="cpu")
        st = tr.init_state(0)
        states.append(tr.train_step(st, b)[0])
    for (k, a), (_, c) in zip(states[0].g.net.state_dict().items(),
                              states[1].g.net.state_dict().items()):
        assert (a - c).abs().max() <= 5e-6, k


def test_a_batch_the_virtual_batch_does_not_divide_raises():
    tr = SRTrainer(options(virtual_batch_size=3), dtype=torch.float32,
                   device="cpu")
    st = tr.init_state(0)
    with pytest.raises(ValueError, match="C 19"):
        tr.train_step(st, {k: torch.from_numpy(v)
                           for k, v in batches(1)[0].items()})


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_freeze_d_steps_match_jax(optim):
    """``freeze_loc: 4``: the first four names of D's flax tree, sorted
    (conv0_0, conv0_1, conv1_0, conv1_1), get zero gradients; the steps
    match JAX's, and with SGD the frozen weights do not move."""
    opt = options(optim, 1e-2 if optim == "sgd" else 1e-4, freeze_loc=4)
    jt, jstate, pt, pstate = pair(opt)
    names = d_flax_names(pstate.d.net)
    assert sorted(set(names.values())) == sorted(_numpy(jstate.d.params))
    frozen = sorted(set(names.values()))[:4]
    assert frozen == ["conv0_0", "conv0_1", "conv1_0", "conv1_1"]
    before = _nets(pstate)["d"]
    _, jstate, _, pstate = run(opt, 3)
    after = _nets(pstate)["d"]
    for k in before:
        if names.get(k) in frozen and optim == "sgd":
            assert np.array_equal(before[k], after[k]), k


def test_a_frozen_parameter_moves_on_its_adam_moments():
    """A zero gradient after real ones: Adam (as optax) still moves the
    parameter by its decaying first moment."""
    from trainner_tpu_torch.train.optimizers import build_optimizer

    p = torch.nn.Parameter(torch.ones(3))
    opt = build_optimizer([p], "adam")
    p.grad = torch.ones(3)
    opt.step(1e-2)
    before = p.detach().clone()
    p.grad = torch.zeros(3)
    opt.step(1e-2)
    assert (p.detach() < before).all()


@pytest.mark.parametrize("lpf,hpf,d_norm", [
    ("average", "average", "batch"), ("gaussian", "gaussian", None),
    ("average", "gaussian", None)])
def test_frequency_separation_steps_match_jax(lpf, hpf, d_norm):
    """``fs``: the low pass into the loss stack, the high pass on D's
    inputs in both stages, with each filter type. The gaussian high pass
    runs with a D without batch norms: its output, (x - low(x) + 1) / 2,
    varies little, and D's first batch norm divides by that small spread,
    which magnifies the two packages' 1e-7 differences in the filter into
    1e-4 in D's logits after one update and 2e-3 after two; without the
    norms the logs agree to 2e-6."""
    opt = options(fs=True, lpf_type=lpf, hpf_type=hpf, D_update_ratio=2)
    opt["network_D"]["norm_type"] = d_norm
    run(opt, 3)


def test_swa_steps_match_jax():
    """``use_swa`` from step 1 with ``swa_lr``: the average is updated
    after steps 1 and 2 (from ``swa_start_iter`` itself), the rate
    switches after step 1 (strictly past it); the SWA weights within 1e-6
    of JAX's, ``swa_n`` equal."""
    opt = options(swa_start_iter=1, swa_lr=2e-3)
    opt["use_swa"] = True
    _, jstate, pt, pstate = run(opt, 3)
    assert [pt.schedG.get_lr(s) for s in range(3)] == [1e-2, 1e-2, 2e-3]
    assert int(pstate.swa_n) == int(jstate.swa_n) == 2
    want = carried(jstate)["swa"]
    for k, v in pstate.swa.named_parameters():
        assert (v - want[k]).abs().max() <= 1e-6, k


STATE_OPTIONS = [("ranger", {}), ("madgrad", {"weight_decay_G": 1e-2}),
                 ("adamp", {}), ("sgdp", {}),
                 ("rmsprop", {"weight_decay_D": 1e-2})]


@pytest.mark.parametrize("optim,extra", STATE_OPTIONS)
def test_a_port_state_loads_in_jax_and_back(optim, extra, tmp_path):
    """A state with every new part (SWA, the LocNet, the clip history,
    the optimizer's state) after two steps: saved by the port, loaded by
    the JAX ``load_state`` on its template with equal values; saved by
    JAX, loaded by the port's ``load_state`` with equal values."""
    opt = options(optim, 1e-3, crop=28, grad_clip="auto",
                  swa_start_iter=0, atg_start_iter=0, **extra)
    opt["use_swa"] = opt["use_atg"] = True
    jt, jstate, pt, pstate = run(opt, 2, lr_px=7)
    path = str(tmp_path / "port.state")
    C.save_state(pstate, path, epoch=1)
    loaded, meta = JC.load_state(path, jstate)
    assert meta["iter"] == 2 and int(loaded.step) == 2
    want = carried(loaded)
    for w in ("g", "d"):
        for k, v in getattr(pstate, w).net.state_dict().items():
            assert torch.equal(v, want[w][k]), (w, k)
    for k, v in pstate.swa.named_parameters():
        assert torch.equal(v.detach(), want["swa"][k]), k
    for k, v in pstate.loc.net.state_dict().items():
        assert torch.equal(v, want["loc"][k]), k
    assert int(loaded.swa_n) == int(pstate.swa_n)
    np.testing.assert_array_equal(np.asarray(loaded.grad_hist["vals"]),
                                  pstate.grad_hist["vals"].numpy())
    for w in ("g", "d", "loc"):
        mine_opt = getattr(pstate, w).opt.state_dict()
        names = [n for n, _ in getattr(pstate, w).net.named_parameters()]
        for key in getattr(pstate, w).opt.lists:
            for n, t in zip(names, mine_opt[key]):
                assert torch.equal(t, want[f"{w}_opt"][key][n]), (w, key)
        if getattr(pstate, w).opt.name in ("adamp", "ranger", "madgrad"):
            # sgdp and rmsprop keep no count in optax
            assert mine_opt["count"] == want[f"{w}_opt"]["count"]
    # the JAX state, saved by JAX, into a fresh port state
    jpath = str(tmp_path / "jax.state")
    JC.save_state(jstate, jpath, epoch=1)
    fresh = pt.init_state(1)
    fresh, _ = C.load_state(jpath, fresh)
    c = carried(jstate)
    for w in ("g", "d"):
        for k, v in getattr(fresh, w).net.state_dict().items():
            assert torch.equal(v, c[w][k]), (w, k)
    for k, v in fresh.swa.named_parameters():
        assert torch.equal(v.detach(), c["swa"][k]), k
    for k, v in fresh.loc.net.state_dict().items():
        assert torch.equal(v, c["loc"][k]), k
    assert int(fresh.swa_n) == int(jstate.swa_n)
    assert int(fresh.grad_hist["n"]) == int(jstate.grad_hist["n"])
    assert torch.equal(fresh.grad_hist["vals"], c["grad_hist"]["vals"])
    for w in ("g", "d", "loc"):
        mine_opt = getattr(fresh, w).opt.state_dict()
        theirs = c[f"{w}_opt"]
        for key, v in theirs.items():
            if isinstance(v, int):
                assert mine_opt[key] == v, (w, key)
        for key in getattr(fresh, w).opt.lists:
            names = [n for n, _ in getattr(fresh, w).net.named_parameters()]
            for n, t in zip(names, mine_opt[key]):
                assert torch.equal(t, theirs[key][n]), (w, key, n)
    # and the port's own save resumes in the port bit for bit
    again = pt.init_state(2)
    again, _ = C.load_state(path, again)
    for w in ("g", "d", "loc"):
        a, b = getattr(again, w).opt.state_dict(), \
            getattr(pstate, w).opt.state_dict()
        for key in getattr(again, w).opt.lists:
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))


ROOT = pathlib.Path(__file__).resolve().parent.parent
DEBUG_YML = ROOT / "options" / "sr" / "train_sr_debug.yml"


@pytest.fixture
def fresh_loggers():
    for name in ("base", "val"):
        close_logger(name)
    yield
    for name in ("base", "val"):
        close_logger(name)


def test_the_cli_with_the_options_resumes_and_serves_swa(tmp_path,
                                                         fresh_loggers):
    """The debug yml at a 56-px crop with SWA (from 2), AdaTarget (from
    1), FreezeD, mixup, DiffAugment, fs, auto clip, a virtual batch of 2
    and ranger: 4 iterations, then a resume to 6 whose loaded state equals
    the saved one; its ``6_swaG.ckpt`` served by the test CLI with
    ``which: swa``."""
    text = DEBUG_YML.read_text().replace(
        "root: /tmp/trainner_tpu_debug", f"root: {tmp_path}")
    text = text.replace("crop_size: 64\n    batch_size: 4",
                        "crop_size: 56\n    batch_size: 4")
    text = text.replace("  size: 64", "  size: 56")
    text = text.replace("use_amp: false", "use_amp: false\nuse_swa: true\n"
                        "use_atg: true")
    text = text.replace("  niter: 12", "  niter: 4\n  swa_start_iter: 2\n"
                        "  swa_lr: 5e-5\n  atg_start_iter: 1\n"
                        "  freeze_loc: 4\n  mixup: true\n  diffaug: true\n"
                        "  dapolicy: color,translation,cutout\n  fs: true\n"
                        "  grad_clip: auto\n  virtual_batch_size: 2\n"
                        "  optim_G: ranger\n  val_freq: 100")
    text = text.replace("save_checkpoint_freq: 8", "save_checkpoint_freq: 4")
    opt1 = tmp_path / "a.yml"
    opt1.write_text(text)
    first = main(["-opt", str(opt1)], device="cpu")
    exp = tmp_path / "experiments" / "debug_sr_synth"
    assert (exp / "models" / "4_swaG.ckpt").exists()
    saved = C.msgpack_restore(open(exp / "training_state" / "4.state",
                                   "rb").read())
    assert saved["loc"] is not None and saved["swa_n"] == 2
    state_dir = exp / "training_state"
    opt2 = tmp_path / "b.yml"
    opt2.write_text(text.replace("  niter: 4", "  niter: 6").replace(
        "path:\n", f"path:\n  resume_state: {state_dir}\n"))
    resumed = main(["-opt", str(opt2)], device="cpu")
    assert resumed.step == 6 and int(resumed.swa_n) == 4
    assert first.step == 4
    test_opt = {
        "name": "swa_serve", "model": "sr", "scale": 4, "which": "swa",
        "datasets": {"test": {"name": "t", "mode": "synthetic",
                              "n_samples": 1, "crop_size": 32}},
        "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8},
        "path": {"root": str(tmp_path / "serve"),
                 "pretrain_model_G": str(exp / "models" / "6_swaG.ckpt")}}
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(test_opt))
    averages = test_cli.main(["-opt", str(path)], device="cpu")
    assert "t" in averages
    out = list((tmp_path / "serve" / "results").rglob("*.png"))
    assert len(out) == 1
