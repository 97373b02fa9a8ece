"""The port's inference CLI (``trainner_tpu_torch/test.py``) against the JAX
CLI (``test.py``) on the same synthetic dataset and the same flax ``.ckpt``,
and the host-side modules it runs through (options, resize, PNG writing,
metrics) against their JAX-package counterparts. Everything runs on the CPU
(``device="cpu"``)."""

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
from trainner_tpu.data.common import save_img as jax_save_img
from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu.ops.imresize import imresize_np as jax_imresize_np
from trainner_tpu.options import parse as jax_parse
from trainner_tpu.utils import metrics as jax_metrics
from trainner_tpu.utils.checkpoint import save_params
from trainner_tpu_torch import test as port_test_cli
from trainner_tpu_torch.data.common import read_img, save_img
from trainner_tpu_torch.ops.imresize import imresize_np
from trainner_tpu_torch.options import parse
from trainner_tpu_torch.utils import metrics

_AVG = re.compile(r"\[(\w+)\] average \((\d+) images\) \| (.*)")


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _averages(lines):
    """The averages of the JAX CLI's dataset summary line."""
    for ln in lines:
        m = _AVG.search(ln)
        if m:
            vals = dict(re.findall(r"(\w+): ([-\d.e+inf]+)", m.group(3)))
            return int(m.group(2)), {k: float(v) for k, v in vals.items()}
    raise AssertionError(f"no average line in {lines}")


def _flax_ckpt(path):
    """A small flax RRDBNet's weights, drawn at unit gain with numpy so that
    G's output is of size ~1, saved with the JAX package's save_params."""
    net = JaxRRDBNet(nf=16, nb=2, nr=3, gc=8, upscale=4, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    v = net.init({"params": rng, "noise": rng}, jnp.zeros((1, 8, 8, 3)),
                 train=False)
    draw = np.random.RandomState(7)
    params = jax.tree.map(
        lambda a: ((draw.randn(*a.shape) / np.sqrt(np.prod(a.shape[:3])))
                   if a.ndim == 4 else draw.randn(*a.shape) * 0.05
                   ).astype(np.float32), v["params"])
    save_params(params, str(path))


def _options(tmp_path, name, ckpt, **extra):
    opt = {"name": name, "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                   "crop_size": 32, "n_samples": 2}},
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8},
           "path": {"root": str(tmp_path), "pretrain_model_G": str(ckpt)},
           "metrics": "psnr,ssim", **extra}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(opt))
    return str(path)


@pytest.mark.parametrize("use_amp,psnr_tol,ssim_tol,png_tol", [
    # f32: G's outputs agree within 1e-5, so at most a few 8-bit pixels
    # round the other way, by one level
    (False, 1e-3, 1e-4, 1),
    # bf16: the two packages round at other places (see
    # test_torch_rrdbnet): up to two bf16 ulps at outputs of size ~1,
    # which is four 8-bit levels, on a few pixels
    (True, 5e-2, 2e-3, 4),
])
def test_port_cli_matches_jax_cli(tmp_path, use_amp, psnr_tol, ssim_tol,
                                  png_tol):
    ckpt = tmp_path / "G.ckpt"
    _flax_ckpt(ckpt)
    records = _Records()
    base = logging.getLogger("base")
    level = base.level
    base.setLevel(logging.INFO)
    base.addHandler(records)
    try:
        jax_test_cli.main(["-opt", _options(tmp_path, "jax", ckpt,
                                            use_amp=use_amp)])
        n_jax, want = _averages(records.lines)
        records.lines.clear()
        got = port_test_cli.main(
            ["-opt", _options(tmp_path, "port", ckpt, use_amp=use_amp)],
            device="cpu")
        n_port, logged = _averages(records.lines)
    finally:
        base.removeHandler(records)
        base.setLevel(level)
    assert n_jax == n_port == 2
    assert set(want) == set(logged) == {"psnr", "ssim", "psnr_Y", "ssim_Y"}
    returned = {m["name"]: m["average"] for m in got["synth"]}
    for k in want:
        assert np.isfinite(returned[k])
        assert abs(returned[k] - logged[k]) <= 1e-5 * abs(logged[k])
        tol = psnr_tol if k.startswith("psnr") else ssim_tol
        assert abs(returned[k] - want[k]) <= tol, (k, returned[k], want[k])
    # the PNGs agree too, read back with cv2
    for i in range(2):
        a = cv2.imread(str(tmp_path / "results" / "jax" / "synth"
                           / f"{i}.png"))
        b = cv2.imread(str(tmp_path / "results" / "port" / "synth"
                           / f"{i}.png"))
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= png_tol


@pytest.mark.parametrize("key,value,item", [
    ("model", "ppon", "C 20"), ("spatial_shards", 2, "Queue A 9")])
def test_port_cli_deferred_branches_raise(tmp_path, key, value, item):
    """x8 and chop are served (test_torch_inference_modes), CEM too
    (test_torch_cem), and ``model: ppon`` (test_torch_ppon_trainer); what
    the JAX CLI cannot run with PPON (CEM's ``out_orig``: its
    ``eval_step`` takes no ``apply_cem``) and the band-parallel branch
    still raise and name their ROADMAP item."""
    extra = {key: value}
    if key == "model":
        extra.update(use_cem=True, cem_config={"out_orig": True})
    path = _options(tmp_path, "deferred", tmp_path / "none.ckpt", **extra)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        port_test_cli.main(["-opt", path], device="cpu")


def test_port_cli_refuses_missing_card(tmp_path, monkeypatch):
    """Asked for the card (the default) where none is present, the CLI
    raises; it never runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _options(tmp_path, "nocard", tmp_path / "none.ckpt")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_test_cli.main(["-opt", path])


def test_options_parse_matches_jax():
    """The JSON options of the repo (with // comments) parse to the same
    network and dataset config in both packages."""
    path = "options/sr/test_sr.json"
    got, want = parse(path, is_train=False), jax_parse(path, is_train=False)
    assert got["network_G"] == want["network_G"]
    assert got["path"] == want["path"]
    for k in want["datasets"]:
        for field in ("phase", "scale", "mode", "dataroot_HR",
                      "dataroot_LR", "data_type", "name"):
            assert got["datasets"][k][field] == want["datasets"][k][field]
    assert got["missing"] is None


@pytest.mark.parametrize("shape,scale", [((40, 24, 3), 0.25),
                                         ((17, 30, 3), 0.5),
                                         ((12, 9), 2.0)])
def test_imresize_matches_jax(shape, scale):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_allclose(imresize_np(img, scale),
                               jax_imresize_np(img, scale), atol=1e-6)


def test_png_writer_round_trips(tmp_path):
    """The stdlib PNG writer matches cv2's pixels (RGB and gray) and
    read_img reads its files back."""
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (13, 21, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (7, 5)).astype(np.uint8)
    save_img(rgb, str(tmp_path / "a.png"))
    jax_save_img(rgb, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))
    np.testing.assert_array_equal(
        read_img(str(tmp_path / "a.png")), rgb.astype(np.float32) / 255.0)
    save_img(gray, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), gray)


@pytest.mark.parametrize("only_y", [False, True])
def test_metrics_match_jax(only_y):
    """PSNR and SSIM (scipy separable window in place of cv2.filter2D)
    against the JAX package's cv2 implementation."""
    rng = np.random.RandomState(2)
    gt = rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
    sr = np.clip(gt.astype(int) + rng.randint(-20, 21, gt.shape),
                 0, 255).astype(np.uint8)
    got = metrics.MetricsDict("psnr,ssim").calculate_metrics(
        sr, gt, crop_size=4, only_y=only_y)
    want = jax_metrics.MetricsDict("psnr,ssim").calculate_metrics(
        sr, gt, crop_size=4, only_y=only_y)
    assert abs(got["psnr"] - want["psnr"]) < 1e-9
    assert abs(got["ssim"] - want["ssim"]) < 1e-9


def _write_pngs(root, sizes, seed):
    rng = np.random.RandomState(seed)
    root.mkdir()
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(root / f"im{i}.png"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("mode,with_lr", [("aligned", False),
                                          ("aligned", True),
                                          ("single", False)])
def test_eval_datasets_and_loader_match_jax(tmp_path, mode, with_lr):
    """The inference datasets, through both packages' loaders, give the
    same batches: HR modcropped to the scale, LR from the LR root or the
    bicubic downscale of HR."""
    from trainner_tpu.data import create_dataloader as jax_loader
    from trainner_tpu.data import create_dataset as jax_dataset
    from trainner_tpu_torch.data import create_dataloader, create_dataset

    hr_sizes = [(37, 30), (24, 42)]
    opt = {"mode": mode, "phase": "test", "scale": 4, "name": "d"}
    if mode == "aligned":
        opt["dataroot_HR"] = _write_pngs(tmp_path / "hr", hr_sizes, 3)
    if with_lr or mode == "single":
        opt["dataroot_LR"] = _write_pngs(
            tmp_path / "lr", [(h // 4, w // 4) for h, w in hr_sizes], 4)
    want = list(jax_loader(jax_dataset(dict(opt)), dict(opt)))
    got = list(create_dataloader(create_dataset(dict(opt)), dict(opt)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_allclose(g[k].numpy(), w[k], atol=1e-6)
            else:
                assert g[k] == w[k]


def test_loader_hands_a_dataset_failure_to_the_consumer():
    from trainner_tpu_torch.data.loader import DataLoader

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 1:
                raise IOError("unreadable image")
            return {"LR": np.zeros((2, 2, 3), np.float32)}

    batches = []
    with pytest.raises(IOError, match="unreadable"):
        for b in DataLoader(Broken(), num_workers=1):
            batches.append(b)
    assert len(batches) == 1
