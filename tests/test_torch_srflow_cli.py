"""Both CLIs of the port with ``model: srflow`` on the CPU, for
``srflow_net`` and ``flow.interop``, at a debug width (nf 8, nb 2, gc 4,
K 2, L 3, hidden 8) on ``train_srflow.yml``'s keys (the aligned dataset
with ``lr_downscale`` by ``matlab_bicubic`` on the device, MultiStepLR,
the encoder frozen for the first half of ``niter``): the training CLI for
4 iterations (checkpoints at 2 and 4, validation at heat 0 at 2 and 4),
a resume from ``training_state/2.state`` to 6 (``niter`` 6: the encoder
unfreezes at 3), then the test CLI on the saved G with two heats and two
samples each: ``{name}_h{heat:.2f}_{k}.png`` for each, equal within a
heat, the first heat's image saved as ``{name}.png`` and scored, heat 0
equal to the trainer's ``eval_step`` on the same G.
"""

import json
import os

import numpy as np
import pytest
import torch

from trainner_tpu_torch import test as test_cli
from trainner_tpu_torch.data.common import read_png, save_img, tensor2img
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train import main
from trainner_tpu_torch.train.srflow_trainer import SRFlowTrainer

torch.set_num_threads(2)


def _images(root, n, px, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        base = rng.rand(px // 8, px // 8, 3)
        img = np.kron(base, np.ones((8, 8, 1))) + 0.1 * rng.rand(px, px, 3)
        save_img((np.clip(img, 0, 1) * 255).astype(np.uint8),
                 os.path.join(root, f"{i:03d}.png"))


def _g(interop: bool) -> str:
    flow = "{L: 3, hidden_channels: 8, stackRRDB: {blocks: [0, 1]}" + (
        ", interop: true}" if interop else "}")
    return f"""network_G:
  type: srflow_net
  nf: 8
  nb: 2
  gc: 4
  K: 2
  flow: {flow}
"""


def _train_yml(tmp_path, data, interop, niter, resume=None):
    text = f"""name: srflow_cli
model: srflow
scale: 4
datasets:
  train:
    name: t
    mode: aligned
    dataroot_HR: {data}/train
    crop_size: 32
    batch_size: 2
    n_workers: 1
    lr_downscale: true
    lr_downscale_types: [matlab_bicubic]
  val:
    name: v
    mode: aligned
    dataroot_HR: {data}/val
{_g(interop)}
val: {{heats: [0.0, 0.5], n_sample: 2}}
path:
  root: {tmp_path / 'root'}
{f'  resume_state: {resume}' if resume else ''}
train:
  lr_G: 2e-4
  lr_scheme: MultiStepLR
  lr_steps_rel: [0.5, 0.75]
  lr_gamma: 0.5
  niter: {niter}
  fl_weight: 1.0
  train_RRDB_delay: 0.5
  grad_clip: norm
  grad_clip_value: 1.0
  val_freq: 2
logger: {{print_freq: 1, save_checkpoint_freq: 2}}
"""
    path = tmp_path / f"train_{niter}.yml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("interop", [False, True], ids=["net", "interop"])
def test_both_clis_run_srflow_on_the_cpu(tmp_path, interop):
    data = tmp_path / "data"
    _images(str(data / "train"), 4, 48, 0)
    _images(str(data / "val"), 1, 32, 1)
    state = main(["-opt", _train_yml(tmp_path, data, interop, 4)],
                 device="cpu")
    assert state.step == 4
    exp = tmp_path / "root" / "experiments" / "srflow_cli"
    for f in ("models/2_G.ckpt", "models/4_G.ckpt",
              "training_state/4.state", "val_images/000/000_4.png"):
        assert (exp / f).exists(), f
    state = main(["-opt", _train_yml(tmp_path, data, interop, 6,
                                     exp / "training_state" / "2.state")],
                 device="cpu")
    assert state.step == 6
    rows = [json.loads(line) for line in
            (exp / "tb" / "scalars.jsonl").read_text().splitlines()]
    nll = [r["value"] for r in rows if r["tag"] == "train/nll"]
    assert len(nll) == 8 and all(np.isfinite(nll))

    lr_dir = tmp_path / "lr"
    _images(str(lr_dir), 2, 8, 2)
    g_path = str(exp / "models" / "6_G.ckpt")
    opt = {"name": "srflow_test", "model": "srflow", "scale": 4,
           "is_train": False,
           "network_G": {"type": "srflow_net", "nf": 8, "nb": 2, "gc": 4,
                         "K": 2, "flow": {"L": 3, "hidden_channels": 8,
                                          "stackRRDB": {"blocks": [0, 1]},
                                          "interop": interop}},
           "datasets": {"test_1": {"name": "seta", "mode": "LR",
                                   "dataroot_LR": str(lr_dir)}},
           "val": {"heats": [0.0, 0.5], "n_sample": 2},
           "path": {"root": str(tmp_path / "test"),
                    "pretrain_model_G": g_path}}
    path = tmp_path / "test.json"
    path.write_text(json.dumps(opt))
    test_cli.main(["-opt", str(path)], device="cpu")
    res = tmp_path / "test" / "results" / "srflow_test" / "seta"
    names = sorted(os.listdir(res))
    want = sorted([f"{i:03d}.png" for i in range(2)] + [
        f"{i:03d}_h{h:.2f}_{k}.png" for i in range(2) for h in (0.0, 0.5)
        for k in range(2)])
    assert names == want
    trainer = SRFlowTrainer(parse_dict(opt, is_train=False), device="cpu")
    served = trainer.init_state(0, g_path)
    for i in range(2):
        img = {n: read_png(str(res / n)) for n in names
               if n.startswith(f"{i:03d}")}
        assert img[f"{i:03d}.png"].shape == (32, 32, 3)
        assert np.array_equal(img[f"{i:03d}_h0.00_0.png"],
                              img[f"{i:03d}_h0.00_1.png"])
        assert np.array_equal(img[f"{i:03d}_h0.50_0.png"],
                              img[f"{i:03d}_h0.50_1.png"])
        assert np.array_equal(img[f"{i:03d}.png"],
                              img[f"{i:03d}_h0.00_0.png"])
        lr = read_png(str(lr_dir / f"{i:03d}.png"))
        x = torch.from_numpy(lr[None].astype(np.float32) / 255.0)
        y = tensor2img(trainer.eval_step(served, x, 0.0)[0])
        assert np.abs(y.astype(int)
                      - img[f"{i:03d}.png"].astype(int)).max() <= 1
