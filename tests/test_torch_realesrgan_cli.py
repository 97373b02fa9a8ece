"""``options/sr/train_realesrgan.yml`` through the port's training CLI on
the CPU (``trainner_tpu_torch.train.main(argv, device="cpu")``) at debug
width: G nf 16, nb 2, gc 8, the U-Net D at nf 8, batch 4 at crop 64, the
resrgan degradations, EMA, validation by PSNR and SSIM on the EMA weights
of the step it follows, the JSONL scalars of ``tensorboard: true``; then a
resume whose EMA and spectral-norm state load bit for bit."""

import copy
import json

import numpy as np
import pytest
import torch

from trainner_tpu_torch.data import save_img
from trainner_tpu_torch.data.common import decode_image
from trainner_tpu_torch.ops.imresize import imresize_np
from trainner_tpu_torch.options.config import read_yaml
from trainner_tpu_torch.train import main
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.logging_utils import close_logger

from test_torch_realesrgan_step import YML

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    for name in ("base", "val"):
        close_logger(name)
    yield
    for name in ("base", "val"):
        close_logger(name)


def _corpus(root, n, px, seed):
    """``n`` PNGs of ``px`` x ``px`` with a 1/f spectrum from a seed."""
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(px)
    radius = np.hypot(f[:, None], f[None, :])
    radius[0, 0] = 1.0
    root.mkdir()
    for i in range(n):
        img = np.fft.ifft2(np.fft.fft2(rng.standard_normal((3, px, px)))
                           / radius).real
        img = (img - img.mean()) / img.std() * 0.18 + 0.5
        save_img((np.clip(img, 0, 1) * 255).round().astype(np.uint8)
                 .transpose(1, 2, 0), str(root / f"{i:03d}.png"))
    return str(root)


def _options(tmp_path, niter, resume=None):
    """``train_realesrgan.yml`` as written but for the widths, the batch,
    the data roots, ``niter``, the frequencies and ``path.root``."""
    opt = read_yaml(str(YML))
    ds = opt["datasets"]
    ds["train"].update(dataroot_HR=str(tmp_path / "train"), batch_size=4,
                       crop_size=64, n_workers=1)
    ds["val"].update(dataroot_HR=str(tmp_path / "val_HR"),
                     dataroot_LR=str(tmp_path / "val_LR"))
    opt["network_G"].update(nf=16, nb=2, gc=8)
    opt["network_D"].update(nf=8)
    opt["train"].update(niter=niter, val_freq=4)
    opt["logger"].update(print_freq=2, save_checkpoint_freq=4)
    opt["path"] = {"root": str(tmp_path / "run")}
    if resume:
        opt["path"]["resume_state"] = resume
    path = tmp_path / f"opt_{niter}.json"
    path.write_text(json.dumps(opt))
    return str(path)


def test_train_realesrgan_runs_through_main(tmp_path, monkeypatch):
    _corpus(tmp_path / "train", 8, 96, 0)
    _corpus(tmp_path / "val_HR", 2, 64, 1)
    (tmp_path / "val_LR").mkdir()
    for p in sorted((tmp_path / "val_HR").iterdir()):
        save_img(imresize_np(decode_image(str(p)), 0.25),
                 str(tmp_path / "val_LR" / p.name))
    evals, outs = [], []
    orig = SRTrainer.eval_step

    def eval_step(self, state, lr_img, which="auto"):
        evals.append(which)
        out = orig(self, state, lr_img, which)
        outs.append((lr_img.clone(), out.clone()))
        return out

    monkeypatch.setattr(SRTrainer, "eval_step", eval_step)
    state = main(["-opt", _options(tmp_path, 8)], device="cpu")
    assert state.step == 8 and state.ema is not None
    assert type(state.d.net).__name__ == "UNetDiscriminator"
    exp = tmp_path / "run" / "experiments" / "realesrgan_x4"
    models = sorted(p.name for p in (exp / "models").iterdir()
                    if not p.name.startswith("previous_"))
    assert models == [f"{t}_{n}.ckpt" for t in (4, 8)
                      for n in ("D", "G", "emaG")]
    # validation through the EMA weights ('auto'), PSNR and SSIM logged
    assert evals == ["auto"] * 4
    # the last validation ran the EMA weights as the last step left them,
    # not as the first validation packed them
    net = copy.deepcopy(state.g.net)
    net.load_state_dict(state.ema.state_dict())
    for lr_img, out in outs[2:]:
        with torch.inference_mode():
            assert torch.equal(out, net.eval()(lr_img.float()).float())
    rows = [json.loads(line) for line in (exp / "tb" / "scalars.jsonl")
            .read_text().splitlines()]
    tags = {(r["tag"], r["step"]) for r in rows}
    assert {("val/psnr", 4), ("val/ssim", 8), ("train/l_g_gan", 8),
            ("train/l_d_total", 2)} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)
    saved = {k: v.clone() for k, v in state.ema_params.items()}
    saved.update({f"d.{k}": v.clone()
                  for k, v in state.d.net.state_dict().items()})

    loaded = {}
    orig_load = C.load_state

    def load_state(path, st):
        st, meta = orig_load(path, st)
        loaded.update({k: v.clone() for k, v in st.ema_params.items()})
        loaded.update({f"d.{k}": v.clone()
                       for k, v in st.d.net.state_dict().items()})
        return st, meta

    monkeypatch.setattr(C, "load_state", load_state)
    for name in ("base", "val"):
        close_logger(name)
    resumed = main(["-opt", _options(tmp_path, 10,
                                     str(exp / "training_state"))],
                   device="cpu")
    assert resumed.step == 10
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        assert torch.equal(loaded[k], v), k
