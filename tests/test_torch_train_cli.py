"""The port's training CLI (``python -m trainner_tpu_torch.train``,
``trainner_tpu_torch/train/cli.py``) on the CPU, against the JAX package's
``train.py`` on the same options (``options/sr/train_sr_debug.yml`` under a
temporary root): the same artifacts, log and validation iterations and
learning rates; resume to a larger ``niter``; the save on an interrupt;
and the options the CLI reads besides (precision, NaN checks, the
profiler, ``parallel``)."""

import json
import os
import pathlib
import re
import signal
import threading

import numpy as np
import pytest
import torch

import train as jax_train_cli
from trainner_tpu_torch.train import cli
from trainner_tpu_torch.train import main
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.debug import check_finite
from trainner_tpu_torch.utils.logging_utils import (ScalarWriter,
                                                    close_logger,
                                                    sorted_nicely)
from trainner_tpu_torch.utils.metrics import Timer

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEBUG_YML = ROOT / "options" / "sr" / "train_sr_debug.yml"
EXP = "debug_sr_synth"


def _options(tmp_path, root, edits=(), name="opt.yml"):
    """The debug config with its root under ``tmp_path`` and ``edits``
    ((old, new) text pairs) applied."""
    text = DEBUG_YML.read_text().replace("root: /tmp/trainner_tpu_debug",
                                         f"root: {tmp_path / root}")
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _tree(root):
    """The experiment's files, relative, with the time stamps of the log
    files' names cut."""
    exp = pathlib.Path(root) / "experiments" / EXP
    return sorted(re.sub(r"_\d{6}-\d{6}\.log$", ".log",
                         str(p.relative_to(exp)))
                  for p in exp.rglob("*") if p.is_file())


def _log_lines(root):
    exp = pathlib.Path(root) / "experiments" / EXP
    (log,) = exp.glob("train_*.log")
    steps = [(int(m.group(1).replace(",", "")), float(m.group(2)))
             for m in re.finditer(r"iter:\s*([\d,]+), lr:([\d.e+-]+)",
                                  log.read_text())]
    vals = [int(m.group(1)) for m in re.finditer(
        r"# Validation # epoch \d+ iter (\d+)", log.read_text())]
    return steps, vals


@pytest.fixture(autouse=True)
def _fresh_loggers():
    """Both CLIs log through the process-wide ``base`` and ``val``
    loggers; each run here starts with none."""
    for name in ("base", "val"):
        close_logger(name)
    yield
    for name in ("base", "val"):
        close_logger(name)


def test_the_cli_writes_what_the_jax_cli_writes(tmp_path):
    """The debug config with ``lr_steps_rel: [0.5]`` (the learning rate
    halves at iteration 6 of 12): the same files, log lines at the same
    iterations with the same learning rates, validation at the same
    iterations, and 12 steps taken."""
    edits = [("lr_steps: [100]", "lr_steps_rel: [0.5]")]
    jax_opt = _options(tmp_path, "jax", edits, "jax.yml")
    port_opt = _options(tmp_path, "port", edits, "port.yml")
    jax_train_cli.main(["-opt", jax_opt])
    for name in ("base", "val"):
        close_logger(name)
    state = main(["-opt", port_opt], device="cpu")
    assert state.step == 12
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert "models/12_G.ckpt" in _tree(tmp_path / "port")
    assert "val_images/0/0_8.png" in _tree(tmp_path / "port")
    steps, vals = _log_lines(tmp_path / "port")
    assert (steps, vals) == _log_lines(tmp_path / "jax")
    assert [s for s, _ in steps] == [2, 4, 6, 8, 10, 12] and vals == [8]
    assert steps[2][1] == pytest.approx(5e-5) and steps[1][1] == 1e-4


def test_resume_continues_to_a_larger_niter(tmp_path):
    """A second run with ``resume_state`` (the directory) and ``niter``
    16 starts from the state saved at 12, which it loads bit for bit,
    and ends at 16."""
    first = main(["-opt", _options(tmp_path, "run")], device="cpu")
    saved = {k: v.clone() for k, v in first.g.net.state_dict().items()}
    saved_mu = [t.clone() for t in first.g.opt.mu]
    loaded = {}
    orig = C.load_state

    def spy(path, state):
        state, meta = orig(path, state)
        loaded["path"] = path
        loaded["g"] = {k: v.clone() for k, v in
                       state.g.net.state_dict().items()}
        loaded["mu"] = [t.clone() for t in state.g.opt.mu]
        loaded["step"] = state.step
        return state, meta

    state_dir = tmp_path / "run" / "experiments" / EXP / "training_state"
    opt2 = _options(tmp_path, "run", [
        ("niter: 12", "niter: 16"),
        ("  root: ", f"  resume_state: {state_dir}\n  root: ")], "2.yml")
    close_logger("base")
    try:
        C.load_state = spy
        second = main(["-opt", opt2], device="cpu")
    finally:
        C.load_state = orig
    assert loaded["path"] == str(state_dir / "12.state")
    assert loaded["step"] == 12 and second.step == 16
    for k, v in saved.items():
        assert torch.equal(loaded["g"][k], v), k
    for a, b in zip(saved_mu, loaded["mu"]):
        assert torch.equal(a, b)
    models = os.listdir(tmp_path / "run" / "experiments" / EXP / "models")
    assert "16_G.ckpt" in models and "16_D.ckpt" in models
    with open(state_dir / "16.state.json") as f:
        assert json.load(f)["iter"] == 16
    logs = sorted((tmp_path / "run" / "experiments" / EXP).glob(
        "train_*.log"))
    assert any("Resuming training from epoch" in p.read_text() and
               "iter 12" in p.read_text() for p in logs)


@pytest.mark.parametrize("how", ["KeyboardInterrupt", "SIGTERM"])
def test_an_interrupt_saves_latest_and_exits_0(how, tmp_path, monkeypatch):
    """An interrupt at the fourth step (Ctrl-C, or SIGTERM, which ``fit``
    turns into one) writes ``latest_*`` with the state of three steps and
    exits with code 0."""
    orig = SRTrainer.train_step

    def step(self, state, batch):
        if state.step == 3:
            if how == "SIGTERM":
                assert threading.current_thread() is threading.main_thread()
                assert signal.getsignal(signal.SIGTERM) is cli._sigterm
                signal.raise_signal(signal.SIGTERM)
            raise KeyboardInterrupt
        return orig(self, state, batch)

    monkeypatch.setattr(SRTrainer, "train_step", step)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        main(["-opt", _options(tmp_path, "run")], device="cpu")
    assert e.value.code == 0
    assert signal.getsignal(signal.SIGTERM) is before
    exp = tmp_path / "run" / "experiments" / EXP
    assert sorted(os.listdir(exp / "models")) == ["latest_D.ckpt",
                                                  "latest_G.ckpt"]
    with open(exp / "training_state" / "latest.state.json") as f:
        assert json.load(f)["iter"] == 3
    assert C.latest_state_path(str(exp / "training_state")).endswith(
        "latest.state")


def test_without_a_card_main_raises(tmp_path, monkeypatch):
    """No ``device`` means the card: with none present the CLI raises and
    writes nothing (it does not fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-opt", _options(tmp_path, "run")])
    assert not (tmp_path / "run").exists()


_SYNTH = "mode: synthetic\n    n_samples: 16"


@pytest.mark.parametrize("edit, item", [
    ((("model: sr", "model: dvd"), ("type: rrdb_net", "type: dvd_net"),
      (_SYNTH, "mode: synthetic\n    kind: dvd\n    n_samples: 16")), None),
    ((("model: sr", "model: pbr"),
      (_SYNTH, "mode: pbr\n    dataroot_HR: {mats}")), None),
    ((("scale: 4", "scale: 4\nparallel: {data: 1}"),
      ("model: sr", "model: cyclegan")), "Queue A 9"),
])
def test_what_the_cli_does_not_port_raises(edit, item, tmp_path):
    """``parallel`` with a model whose step is not on the data axis yet
    raises and names its item (A 9 d; ``parallel`` itself trains since
    Queue A 9 a-c: ``test_torch_parallel.py``); ``model: dvd`` (its
    synthetic kind, ``dvd_net``) and ``model: pbr`` (on seeded material
    folders), once refused here (ROADMAP Queue A 10.6), run 2
    iterations (both CLIs at length: ``test_torch_zoo_rest_cli.py``)."""
    from test_torch_pbr import write_materials

    mats = write_materials(str(tmp_path / "mats"), n=4, px=(64, 64))
    edits = [(old, new.replace("{mats}", mats)) for old, new in edit]
    if item is None:
        opt = _options(tmp_path, "run", edits + [("niter: 12", "niter: 2")])
        state = main(["-opt", opt], device="cpu")
        assert state.step == 2
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main(["-opt", _options(tmp_path, "run", edits)], device="cpu")


def test_profile_debug_nans_and_precision(tmp_path):
    """``profile`` writes a trace under ``log/trace``; ``debug_nans`` and
    ``matmul_precision: high`` are logged, and the TF32 flags are put back
    after the run."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    opt = _options(tmp_path, "run", [
        ("niter: 12", "niter: 2\n  matmul_precision: high"),
        ("use_amp: false", "use_amp: false\nprofile: true\ndebug_nans: true"),
        ("tensorboard: false", "tensorboard: true")])
    assert main(["-opt", opt], device="cpu").step == 2
    exp = tmp_path / "run" / "experiments" / EXP
    assert (exp / "trace" / "trace.json").stat().st_size > 0
    (log,) = exp.glob("train_*.log")
    text = log.read_text()
    assert "matmul_precision = high: TF32 on" in text
    assert "anomaly detection on" in text and "Scalars to" in text
    rows = [json.loads(line) for line in
            (exp / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert {r["tag"] for r in rows} >= {"lr", "train/l_g_total"}
    assert {r["step"] for r in rows} == {2}
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    assert not torch.is_anomaly_enabled()


def test_check_finite_raises_on_a_nan_log():
    check_finite({"a": torch.tensor(1.0)}, 3)
    with pytest.raises(FloatingPointError, match="l_g_total is nan at "
                                                 "iteration 3"):
        check_finite({"a": torch.tensor(1.0),
                      "l_g_total": torch.tensor(float("nan"))}, 3)


def test_scalar_writer_timer_and_sorting(tmp_path):
    w = ScalarWriter(str(tmp_path), use_tb=False)
    assert w.backends == ("jsonl",)
    w.add_scalars({"a": 1.5, "b": 2}, step=7, prefix="val/")
    w.close()
    rows = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("val/a", 1.5, 7), ("val/b", 2.0, 7)]
    t = Timer()
    for _ in range(3):
        t.tic()
        assert t.toc() >= 0.0
    assert t.calls == 3
    assert t.get_average_time() == pytest.approx(t.total_time / 3)
    assert t.calls == 3
    assert sorted_nicely(["10_G.ckpt", "9_G.ckpt", "latest_G.ckpt"]) == [
        "9_G.ckpt", "10_G.ckpt", "latest_G.ckpt"]
    assert np.isfinite(t.total_time)
