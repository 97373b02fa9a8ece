"""Both CLIs of the port on the video models, on a tiny seeded folder of
frames, on the CPU: the training CLI on a copy of
``options/video/train_video.yml`` (SOF-VSR with its RRDB tail at narrow
widths, 32 px crops, the OFR term, validation, checkpoints the JAX
package reads) and a resume from its ``.state``; the test CLI on a copy
of ``test_video.yml`` against the JAX ``test.py`` from one G checkpoint
written by the JAX package, plain and with ``chop``: the same PSNR and
SSIM averages, each window scored on its centre frame.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_unshuffle_step import _redraw
from trainner_tpu.models.sofvsr import SOFVSR as JaxSOFVSR

torch.set_num_threads(2)


def write_videos(root, n_videos=2, n_frames=5, px=64, seed=0):
    """``n_videos`` folders of ``n_frames`` 1/f RGB PNGs of ``px``², each
    frame its predecessor shifted by a pixel or two."""
    from trainner_tpu_torch.data.common import save_img

    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(px)[:, None]
    fx = np.fft.fftfreq(px)[None, :]
    amp = 1.0 / np.maximum(np.sqrt(fx * fx + fy * fy), 1.0 / px)
    for v in range(n_videos):
        spec = amp[..., None] * np.exp(2j * np.pi * rng.rand(px, px, 3))
        img = np.real(np.fft.ifft2(spec, axes=(0, 1)))
        img = (img - img.min()) / (img.max() - img.min())
        d = os.path.join(root, f"video{v}")
        os.makedirs(d, exist_ok=True)
        for f in range(n_frames):
            frame = np.roll(img, (f, 2 * f), axis=(0, 1))
            save_img((frame * 255).round().astype(np.uint8),
                     os.path.join(d, f"{f:03d}.png"))
    return root


def _yml(name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from trainner_tpu_torch.options.config import load_file

    return load_file(os.path.join(root, "options", "video", name))


def _debug_train_options(tmp, videos, niter=4, **path):
    opt = _yml("train_video.yml")
    opt["name"] = "vsr_cli"
    opt["network_G"].update(channels=16, sr_nf=8, sr_nb=1)
    opt["datasets"]["train"].update(dataroot_HR=videos, crop_size=32,
                                    batch_size=2, n_workers=1,
                                    n_samples=8)
    opt["datasets"]["val"]["dataroot_HR"] = os.path.join(videos, "video0")
    opt["train"].update(niter=niter, val_freq=2)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2}
    opt["path"] = {"root": str(tmp), **path}
    return opt


def test_training_cli_trains_and_resumes(tmp_path):
    """The port's training CLI on a copy of ``train_video.yml`` (narrow
    widths, 32 px crops of a seeded folder), then a resume from its
    ``.state``; the JAX package reads the checkpoint it wrote."""
    from trainner_tpu.utils import checkpoint as JC
    from trainner_tpu_torch.train import main as train_main

    videos = write_videos(str(tmp_path / "videos"))
    opt = _debug_train_options(tmp_path, videos)
    p = tmp_path / "train.json"
    p.write_text(json.dumps(opt))
    state = train_main(["-opt", str(p)], device="cpu")
    assert state.step == 4
    exp = tmp_path / "experiments" / "vsr_cli"
    assert (exp / "models" / "4_G.ckpt").exists()
    assert (exp / "val_images" / "003" / "003_4.png").exists()
    jm = JaxSOFVSR(scale=4, n_frames=3, channels=16, sr_net="rrdb",
                   sr_nf=8, sr_nb=1)
    x = jnp.zeros((1, 3, 8, 8, 3))
    template = jm.init({"params": jax.random.PRNGKey(0),
                        "noise": jax.random.PRNGKey(0)}, x,
                       train=False)["params"]
    loaded = JC.load_params(str(exp / "models" / "4_G.ckpt"), template)
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(template)
    opt = _debug_train_options(tmp_path, videos, niter=6,
                               resume_state=str(exp / "training_state"))
    p.write_text(json.dumps(opt))
    state = train_main(["-opt", str(p)], device="cpu")
    assert state.step == 6


def test_test_cli_matches_jax(tmp_path):
    """``test_video.yml`` (narrow widths, ``chop`` off and on) through the
    port's test CLI and the JAX one, from one G checkpoint written by the
    JAX package: the same PSNR and SSIM averages, scored on the centre
    frame of each window."""
    import logging

    import test as jax_test
    from test_torch_inference_modes import _Records, _averages, _run
    from trainner_tpu.utils import checkpoint as JC
    from trainner_tpu_torch import test as port_test

    videos = write_videos(str(tmp_path / "videos"), n_videos=1, n_frames=4,
                          px=128)
    jm = JaxSOFVSR(scale=4, n_frames=3, channels=16, sr_net="rrdb",
                   sr_nf=8, sr_nb=1)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "noise": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 3, 8, 8, 3)), train=False)["params"]
    ckpt = str(tmp_path / "G.ckpt")
    JC.save_params(_redraw(params, 5, 1.0), ckpt)
    records = _Records()
    logging.getLogger("base").addHandler(records)
    try:
        for chop in (False, True):
            got = {}
            for who, cli, kw in (("jax", jax_test.main, {}),
                                 ("port", port_test.main,
                                  {"device": "cpu"})):
                opt = _yml("test_video.yml")
                opt["name"] = f"vsr_test_{who}_{chop}"
                opt["datasets"] = {"test_1": dict(
                    opt["datasets"]["test_1"],
                    dataroot_LR=os.path.join(videos, "video0"))}
                opt["network_G"].update(channels=16, sr_nf=8, sr_nb=1)
                opt["path"] = {"root": str(tmp_path),
                               "pretrain_model_G": ckpt}
                opt["chop"] = chop
                p = tmp_path / f"{who}.json"
                p.write_text(json.dumps(opt))
                _, lines = _run(cli, str(p), records, **kw)
                got[who] = _averages(lines)
            assert got["port"][0] == got["jax"][0] == 2
            for key, want in got["jax"][1].items():
                assert abs(got["port"][1][key] - want) <= \
                    1e-4 * abs(want), (chop, key)
    finally:
        logging.getLogger("base").removeHandler(records)
