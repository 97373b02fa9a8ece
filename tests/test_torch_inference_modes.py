"""The port's x8 self-ensemble and tiled (chop) inference,
``SRTrainer.eval_step_x8`` and ``eval_step_chop``
(``trainner_tpu_torch/train/sr_trainer.py``), against the JAX package's on
the same weights (drawn by the JAX module at unit gain, carried across
with ``params_from_jax``), and ``python -m trainner_tpu_torch.test`` with
``self_ensemble`` and with ``chop`` against the JAX CLI. Everything runs
on the CPU in f32.
"""

import json
import logging
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test as jax_test_cli
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu.utils.checkpoint import save_params
from trainner_tpu_torch import test as port_test_cli
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import params_from_jax

torch.set_num_threads(2)

OPT = {"is_train": False, "scale": 4,
       "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8,
                     "upscale": 4}}


def _unit_gain(params, seed=6):
    """Weights of unit gain, drawn with numpy (as test_torch_rrdbnet): the
    modules' own init leaves G's output near 1e-4, too small to test."""
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if leaf.ndim == 4:
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:3]))
                    ).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)

    return jax.tree.map(draw, params)


@pytest.fixture(scope="module")
def trainers():
    jt = JaxTrainer(dict(OPT), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (1, 8, 8, 3))
    params = _unit_gain(jax.tree.map(np.asarray, jstate.g.params))
    jstate = jstate.replace(g=jstate.g.replace(params=params))
    pt = SRTrainer(dict(OPT), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    pstate.g.net.load_state_dict(params_from_jax(params), strict=True)
    return jt, jstate, pt, pstate


def _lr(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_x8_matches_jax_on_a_non_square_image(trainers):
    """A 40 x 28 LR: the rotations by 90 and 270 degrees run G at 28 x 40,
    so the ensemble meets both shapes. f32 within 1e-5 (outputs of size
    ~1; the eight outputs summed in another order)."""
    jt, jstate, pt, pstate = trainers
    x = _lr((1, 40, 28, 3), 1)
    want = np.asarray(jt.eval_step_x8(jstate, jnp.asarray(x)))
    got = pt.eval_step_x8(pstate, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 160, 112, 3)
    assert np.abs(got - want).max() < 1e-5
    # not the plain forward: the ensemble changes the output
    plain = pt.eval_step(pstate, torch.from_numpy(x)).numpy()
    assert np.abs(got - plain).max() > 1e-3


@pytest.mark.parametrize("shape,patch,overlap,tiles", [
    # tiles of 16 at a stride of 12: rows 0, 12, 21 (the last pinned to the
    # edge) and columns 0, 12, 14
    ((1, 37, 30, 3), 16, 4, 9),
    # 5 x 4 tiles of a batch of two: 40 rows, run as chunks of 32 and 8
    ((2, 55, 41, 3), 16, 4, 20),
    # an image smaller than the patch: tiles of min(patch, h, w) = 12, and
    # the overlap over the tile leaves a stride of 1: nine along w
    ((1, 12, 20, 3), 128, 16, 9),
])
def test_chop_matches_jax(trainers, shape, patch, overlap, tiles):
    """Tiles pinned to the edge, the chunking by 32 rows and the uniform
    blend, against the JAX ``eval_step_chop``: f32 within 1e-5."""
    jt, jstate, pt, pstate = trainers
    x = _lr(shape, 2)
    seen = []
    eval_step = pt.eval_step

    def spy(state, t, *which):
        seen.append(tuple(t.shape))
        return eval_step(state, t, *which)

    pt.eval_step = spy
    try:
        got = pt.eval_step_chop(pstate, torch.from_numpy(x), patch,
                                overlap).numpy()
    finally:
        del pt.eval_step
    want = np.asarray(jt.eval_step_chop(jstate, jnp.asarray(x), patch,
                                        overlap))
    b, h, w, _ = shape
    assert got.shape == want.shape == (b, 4 * h, 4 * w, 3)
    assert np.abs(got - want).max() < 1e-5
    p = min(patch, h, w)
    rows = tiles * b
    assert seen == [(min(32, rows - i), p, p, 3) for i in range(0, rows, 32)]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


_AVG = re.compile(r"\[(\w+)\] average \((\d+) images\) \| (.*)")
_IMG = re.compile(r"^\S+\s+\| psnr: \S+ ssim: \S+ \| psnr_Y: \S+ ssim_Y: \S+$")


def _averages(lines):
    for ln in lines:
        m = _AVG.search(ln)
        if m:
            vals = dict(re.findall(r"(\w+): ([-\d.e+inf]+)", m.group(3)))
            return int(m.group(2)), {k: float(v) for k, v in vals.items()}
    raise AssertionError(f"no average line in {lines}")


def _flax_ckpt(path):
    net_params = _unit_gain(jax.tree.map(
        np.asarray, JaxTrainer(dict(OPT), dtype=jnp.float32).init_state(
            jax.random.PRNGKey(0), (1, 8, 8, 3)).g.params), seed=7)
    save_params(net_params, str(path))


def _options(tmp_path, name, ckpt, **extra):
    opt = {"name": name, "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                   "crop_size": 48, "n_samples": 2}},
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8},
           "path": {"root": str(tmp_path), "pretrain_model_G": str(ckpt)},
           "metrics": "psnr,ssim", **extra}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(opt))
    return str(path)


def _run(cli, path, records, **kw):
    records.lines.clear()
    out = cli(["-opt", path], **kw)
    return out, list(records.lines)


@pytest.mark.parametrize("key", ["self_ensemble", "x8", "chop_forward",
                                 "chop"])
def test_port_cli_serves_x8_and_chop_as_the_jax_cli(tmp_path, key):
    """The CLI with the option on: a PNG per image, one log line per image
    and the dataset's average line, in the plain branch's form; the
    averages within the f32 CLI tolerances of the JAX CLI with the same
    option (PSNR 1e-3, SSIM 1e-4), and the PNGs within one 8-bit level.
    Chop runs 12 x 12 LR images as one tile each, so it matches the plain
    branch too; x8 does not."""
    ckpt = tmp_path / "G.ckpt"
    _flax_ckpt(ckpt)
    records = _Records()
    base = logging.getLogger("base")
    level = base.level
    base.setLevel(logging.INFO)
    base.addHandler(records)
    try:
        _, jax_lines = _run(jax_test_cli.main,
                            _options(tmp_path, "jax", ckpt, **{key: True}),
                            records)
        got, lines = _run(port_test_cli.main,
                          _options(tmp_path, "port", ckpt, **{key: True}),
                          records, device="cpu")
        _, plain_lines = _run(port_test_cli.main,
                              _options(tmp_path, "plain", ckpt), records,
                              device="cpu")
    finally:
        base.removeHandler(records)
        base.setLevel(level)
    n_jax, want = _averages(jax_lines)
    n_port, logged = _averages(lines)
    n_plain, plain = _averages(plain_lines)
    assert n_jax == n_port == n_plain == 2
    assert sum(bool(_IMG.match(ln)) for ln in lines) == 2
    assert sum(bool(_IMG.match(ln)) for ln in plain_lines) == 2
    assert set(logged) == set(plain) == set(want)
    returned = {m["name"]: m["average"] for m in got["synth"]}
    for k in want:
        assert abs(returned[k] - logged[k]) <= 1e-5 * abs(logged[k])
        tol = 1e-3 if k.startswith("psnr") else 1e-4
        assert abs(returned[k] - want[k]) <= tol, (k, returned[k], want[k])
    if key.startswith("chop"):
        assert all(abs(logged[k] - plain[k]) <= 1e-5 * abs(plain[k])
                   for k in plain)
    else:
        assert any(abs(logged[k] - plain[k]) > 1e-4 for k in plain)
    for i in range(2):
        a = cv2.imread(str(tmp_path / "results" / "jax" / "synth"
                           / f"{i}.png"))
        b = cv2.imread(str(tmp_path / "results" / "port" / "synth"
                           / f"{i}.png"))
        assert a.shape == b.shape == (48, 48, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
