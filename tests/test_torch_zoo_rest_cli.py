"""Both CLIs of the port on ``dvd``, ``wbc`` and ``pbr`` at debug widths on
the CPU, on seeded folders: the training CLI for 4 iterations (a
checkpoint at 2 and 4) and a resume to 6 from its ``.state``; the test
CLI on the G of iteration 6. ``dvd``: a copy of
``options/video/train_deinterlace.yml`` (nf 8, b 2, crop 32), served from
a copy of ``test_deinterlace.yml`` whose set names ``dataroot_HR``: each
result with its ``{i}_bottom.png``, both frames equal to the JAX
``test.py``'s from one checkpoint; a ``dvd`` validation set fails as the
JAX CLI's does (ROADMAP C 27). ``wbc``: a copy of
``options/i2i/train_wbc.yml`` (nf 8, D ndf 8, b 2, crop 32, 20 segments,
seeded VGG19 weights), served from a ``single`` set. ``pbr``: ``rrdb_net``
nf 8, nb 2, gc 4 on seeded material folders, its validation on the
primary map, served from a ``pbr`` set.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_dvd import _frames
from test_torch_loss_stack import _vgg19_npz
from test_torch_pbr import write_materials
from trainner_tpu_torch.data.common import read_png, save_img
from trainner_tpu_torch.options.config import load_file

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _template(*parts):
    return load_file(os.path.join(ROOT, "options", *parts))


def _train(tmp, opt, files):
    """The training CLI for 4 iterations, then a resume to 6; each save's
    files are there. Returns the experiment directory."""
    from trainner_tpu_torch.train import main

    opt["train"]["niter"] = 4
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2,
                     "display_freq": 2}
    opt["path"] = {**opt.get("path", {}), "root": str(tmp / "root")}
    path = tmp / "train.json"
    path.write_text(json.dumps(opt))
    state = main(["-opt", str(path)], device="cpu")
    assert state.step == 4
    exp = tmp / "root" / "experiments" / opt["name"]
    opt["train"]["niter"] = 6
    opt["path"]["resume_state"] = str(exp / "training_state")
    path.write_text(json.dumps(opt))
    state = main(["-opt", str(path)], device="cpu")
    assert state.step == 6
    for it in (2, 4, 6):
        for n in files:
            assert (exp / "models" / f"{it}_{n}.ckpt").exists()
        assert (exp / "training_state" / f"{it}.state").exists()
    return exp


def _serve(tmp, opt):
    from trainner_tpu_torch import test as test_cli

    path = tmp / "serve.json"
    path.write_text(json.dumps(opt))
    return test_cli.main(["-opt", str(path)], device="cpu")


def test_dvd_clis(tmp_path):
    frames = _frames(str(tmp_path / "frames"), n=4, hw=(40, 36))
    opt = _template("video", "train_deinterlace.yml")
    opt["network_G"]["nf"] = 8
    opt["datasets"]["train"].update(dataroot_HR=frames, crop_size=32,
                                    batch_size=2, n_workers=1)
    exp = _train(tmp_path, opt, ("G",))
    serve = _template("video", "test_deinterlace.yml")
    serve["network_G"]["nf"] = 8
    ds = serve["datasets"]["test_1"]
    ds.pop("dataroot_LR")
    ds["dataroot_HR"] = frames
    ckpt = str(exp / "models" / "6_G.ckpt")
    serve["path"] = {"root": str(tmp_path / "serve"),
                     "pretrain_model_G": ckpt}
    _serve(tmp_path, serve)
    res = tmp_path / "serve" / "results" / serve["name"] / ds["name"]
    for i in range(3):
        top = read_png(str(res / f"{i:03d}.png"))
        bottom = read_png(str(res / f"{i}_bottom.png"))
        assert top.shape == bottom.shape == (40, 36, 3)
    # the JAX test CLI on the same checkpoint and set
    import test as jax_test
    from trainner_tpu.utils.logging_utils import get_root_logger

    serve["path"]["root"] = str(tmp_path / "jax_serve")
    jpath = tmp_path / "jax_serve.json"
    jpath.write_text(json.dumps(serve))
    jax_test.main(["-opt", str(jpath)])
    jres = tmp_path / "jax_serve" / "results" / serve["name"] / ds["name"]
    for name in ("000.png", "0_bottom.png", "2_bottom.png"):
        a = read_png(str(res / name)).astype(int)
        b = read_png(str(jres / name)).astype(int)
        assert np.abs(a - b).max() <= 1
    for h in list(get_root_logger("base").handlers):
        get_root_logger("base").removeHandler(h)
    # a dvd batch has neither LR nor A: a validation set fails (C 27)
    from trainner_tpu_torch.train import main

    opt = _template("video", "train_deinterlace.yml")
    opt["name"] = "dvd_val"
    opt["network_G"]["nf"] = 8
    opt["datasets"]["train"].update(dataroot_HR=frames, crop_size=32,
                                    batch_size=2, n_workers=1)
    opt["datasets"]["val"] = {"name": "v", "mode": "dvd",
                              "dataroot_HR": frames}
    opt["train"].update(niter=2, val_freq=2)
    opt["path"] = {"root": str(tmp_path / "val_root")}
    path = tmp_path / "val.json"
    path.write_text(json.dumps(opt))
    with pytest.raises(KeyError, match="C 27"):
        main(["-opt", str(path)], device="cpu")


def test_wbc_clis(tmp_path):
    rng = np.random.RandomState(0)
    roots = {}
    for side in ("A", "B"):
        roots[side] = str(tmp_path / side)
        os.makedirs(roots[side])
        for i in range(3):
            save_img((rng.rand(48, 48, 3) * 255).astype(np.uint8),
                     os.path.join(roots[side], f"{side}{i}.png"))
    vgg = _vgg19_npz(tmp_path / "vgg19.npz")
    opt = _template("i2i", "train_wbc.yml")
    opt["network_G"]["nf"] = 8
    opt["network_D"]["ndf"] = 8
    opt["datasets"]["train"].update(dataroot_A=roots["A"],
                                    dataroot_B=roots["B"], crop_size=32,
                                    batch_size=2, n_workers=1,
                                    serial_batches=True)
    opt["train"]["sp_n_segments"] = 20
    opt["path"] = {"vgg_weights": vgg}
    exp = _train(tmp_path, opt, ("G", "D_S", "D_T"))
    assert read_png(str(exp / "samples" / "00000004.png")).shape == \
        (32, 96, 3)
    _serve(tmp_path, {
        "name": "serve_wbc", "model": "wbc", "scale": 1,
        "datasets": {"test_1": {"name": "a", "mode": "single",
                                "dataroot_LR": roots["A"]}},
        "network_G": opt["network_G"],
        "path": {"root": str(tmp_path / "serve"),
                 "pretrain_model_G": str(exp / "models" / "6_G.ckpt")}})
    outs = sorted((tmp_path / "serve").rglob("A*.png"))
    assert len(outs) == 3 and read_png(str(outs[0])).shape == (48, 48, 3)


def test_pbr_clis(tmp_path):
    mats = write_materials(str(tmp_path / "mats"), n=3, px=(48, 48))
    vgg = _vgg19_npz(tmp_path / "vgg19.npz")
    opt = {"name": "pbr_cli", "model": "pbr", "scale": 4,
           "datasets": {"train": {"name": "m", "mode": "pbr",
                                  "dataroot_HR": mats, "crop_size": 32,
                                  "batch_size": 2, "n_workers": 1},
                        "val": {"name": "mv", "mode": "pbr",
                                "dataroot_HR": mats, "crop_size": 32}},
           "network_G": {"type": "rrdb_net", "nf": 8, "nb": 2, "gc": 4},
           "path": {"vgg_weights": vgg},
           "train": {"lr_G": 1e-4, "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "feature_criterion": "l1",
                     "feature_weight": 1.0, "val_freq": 4}}
    exp = _train(tmp_path, opt, ("G",))
    assert (exp / "val_images" / "mat0" / "mat0_4.png").exists()
    rows = [json.loads(line) for line in open(exp / "tb" / "scalars.jsonl")]
    tags = {r["tag"] for r in rows}
    assert {"train/l_g_fea_diffuse", "train/l_g_pix_height",
            "val/psnr"} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)
    averages = _serve(tmp_path, {
        "name": "serve_pbr", "model": "pbr", "scale": 4,
        "datasets": {"test_1": {"name": "m", "mode": "pbr",
                                "dataroot_HR": mats, "crop_size": 48}},
        "network_G": opt["network_G"],
        "path": {"root": str(tmp_path / "serve"),
                 "pretrain_model_G": str(exp / "models" / "6_G.ckpt")}})
    assert len(list((tmp_path / "serve").rglob("mat*.png"))) == 3
    psnr = [m["average"] for m in averages["m"] if m["name"] == "psnr"]
    assert psnr and np.isfinite(psnr[0])
