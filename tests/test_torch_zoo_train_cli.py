"""The port's training CLI on the generator options of this slice, on the
CPU at debug width: ``options/sr/train_sr_debug.yml`` at scale 2 with the
network presets (``gen_esrgan``, ``disc_esrgan``, the inline keys winning)
and the pixel-unshuffle wrapper (G at its own scale 4, unshuffled by 2),
then ``use_cem`` and an ``sr_resnet`` with batch norms; each run for 12
iterations and resumed to 16, the loaded state equal to the saved one bit
for bit."""

import pathlib

import pytest
import torch

from trainner_tpu_torch.train import main
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.logging_utils import close_logger

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEBUG_YML = ROOT / "options" / "sr" / "train_sr_debug.yml"
EXP = "debug_sr_synth"

PRESETS = (
    ("scale: 4\n", "scale: 2\nuse_unshuffle: true\n"
     "network_G_preset: gen_esrgan\nnetwork_D_preset: disc_esrgan\n"),
    ("network_G:\n  type: rrdb_net\n  nf: 16\n  nb: 2\n  gc: 8\n",
     "network_G:\n  scale: 4\n  nf: 16\n  nb: 1\n  gc: 8\n"),
    ("network_D:\n  type: discriminator_vgg\n  size: 64\n  base_nf: 16\n",
     "network_D:\n  nf: 8\n"),
)
CEM_BN = (
    ("scale: 4\n", "scale: 4\nuse_cem: true\ncem:\n  kernel: cubic\n"),
    ("network_G:\n  type: rrdb_net\n  nf: 16\n  nb: 2\n  gc: 8\n",
     "network_G:\n  type: sr_resnet\n  nf: 16\n  nb: 2\n"
     "  norm_type: batch\n  mode: NAC\n"),
)


def _options(tmp_path, root, edits, name):
    text = DEBUG_YML.read_text().replace("root: /tmp/trainner_tpu_debug",
                                         f"root: {tmp_path / root}")
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    for name in ("base", "val"):
        close_logger(name)
    yield
    for name in ("base", "val"):
        close_logger(name)


@pytest.mark.parametrize("edits", [PRESETS, CEM_BN],
                         ids=["presets-unshuffle", "cem-srresnet-bn"])
def test_cli_trains_and_resumes_the_options(tmp_path, edits):
    first = main(["-opt", _options(tmp_path, "run", edits, "1.yml")],
                 device="cpu")
    assert first.step == 12
    net = first.g.net
    if edits is PRESETS:
        assert type(net).__name__ == "RRDBNet"
        assert net.conv_first.weight.shape[1] == 12  # unshuffled by 2
        assert len(net.RRDB_trunk) == 1
        assert first.d.net.conv0_0.weight.shape[0] == 8
    else:
        assert type(net).__name__ == "SRResNet"
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    assert any("running_mean" in k for k in saved) == (edits is CEM_BN)
    loaded = {}
    orig = C.load_state

    def spy(path, state):
        state, meta = orig(path, state)
        loaded["g"] = {k: v.clone() for k, v in
                       state.g.net.state_dict().items()}
        loaded["step"] = state.step
        return state, meta

    state_dir = tmp_path / "run" / "experiments" / EXP / "training_state"
    opt2 = _options(tmp_path, "run", edits + (
        ("niter: 12", "niter: 16"),
        ("  root: ", f"  resume_state: {state_dir}\n  root: ")), "2.yml")
    close_logger("base")
    try:
        C.load_state = spy
        second = main(["-opt", opt2], device="cpu")
    finally:
        C.load_state = orig
    assert loaded["step"] == 12 and second.step == 16
    assert set(loaded["g"]) == set(saved)
    for k, v in saved.items():
        assert torch.equal(loaded["g"][k], v), k
