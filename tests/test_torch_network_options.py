"""The port's parse of the network options against the JAX package's:
``network_G`` / ``network_D`` / ``unshuffle_scale`` of the network
presets (``gen_esrgan``, ``disc_esrgan``), of the pixel-unshuffle wrapper,
of ``options/sr/train_sr.yml`` with its ``use_cem`` / ``use_unshuffle`` /
``plus`` lines uncommented, and of a table of generator and discriminator
specs. Exact equality of the parsed trees."""

import copy
import pathlib

import pytest

from trainner_tpu.options.config import parse as jax_parse
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu.options.defaults import \
    get_network_D_config as jax_get_network_D_config
from trainner_tpu_torch.models.networks import define_D
from trainner_tpu_torch.options.config import parse, parse_dict
from trainner_tpu_torch.options.defaults import (get_network_D_config,
                                                 get_network_G_config)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAIN_SR = ROOT / "options" / "sr" / "train_sr.yml"


def _opt(**extra):
    opt = {"name": "netopts", "model": "sr", "scale": 4,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x", "crop_size": 128,
                                  "batch_size": 4}},
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8},
           "network_D": {"type": "discriminator_vgg_128", "nf": 16},
           "path": {"root": "/tmp/exp"}}
    opt.update(extra)
    return opt


def _both(opt, is_train=True):
    return (parse_dict(copy.deepcopy(opt), is_train=is_train),
            jax_parse_dict(copy.deepcopy(opt), is_train=is_train))


@pytest.mark.parametrize("extra", [
    {"network_G_preset": "gen_esrgan"},
    {"network_D_preset": "disc_esrgan"},
    {"network_G_preset": "gen_esrgan", "network_D_preset": "disc_esrgan",
     "network_G": {"nb": 4, "plus": True}, "network_D": {"nf": 32}},
    {"network_G_preset": "gen_esrgan", "network_G": "rrdb_net"},
], ids=["G", "D", "both-inline-wins", "G-string"])
def test_network_presets_parse_as_in_jax(extra):
    got, want = _both(_opt(**extra))
    assert got["network_G"] == want["network_G"]
    assert got["network_D"] == want["network_D"]
    assert got == want


def test_disc_esrgan_takes_the_crop_size():
    """``disc_esrgan`` names ``discriminator_vgg`` with ``nf`` and no
    size: D-VGG at the crop size with base_nf from ``nf``."""
    got, _ = _both(_opt(network_D_preset="disc_esrgan", network_D=None))
    d = got["network_D"]
    assert (d["type"], d["base_nf"], d["size"]) == ("discriminator_vgg", 64,
                                                    128)
    net = define_D(got)
    assert net.n_blocks == 5


@pytest.mark.parametrize("g, extra", [
    ({"type": "mrrdb_net", "scale": 4, "nf": 16}, {"scale": 2,
                                                   "use_unshuffle": True}),
    ({"type": "mrrdb_net", "scale": 4}, {"scale": 1,
                                         "use_unshuffle": True,
                                         "unshuffle_scale": 4}),
    ("mesrgan", {"scale": 2, "use_unshuffle": True, "unshuffle_scale": 2}),
    ({"type": "rrdb_net", "in_nc": 1, "scale": 4},
     {"scale": 2, "use_unshuffle": True}),
    ({"type": "sr_resnet", "net_act": "prelu", "norm_type": "batch",
      "mode": "NAC"}, {}),
    ({"which_model_G": "srgan", "scale": 2, "group": 1}, {"scale": 2}),
    ({"type": "esrgan-lite", "gaussian": False}, {}),
], ids=["mrrdb-x2", "mrrdb-x1-by4", "mesrgan-str", "rrdb-gray",
        "srresnet-aliases", "srgan", "esrgan-lite"])
def test_generator_specs_and_unshuffle_parse_as_in_jax(g, extra):
    got, want = _both(_opt(network_G=g, **extra))
    assert got["network_G"] == want["network_G"]
    assert got["unshuffle_scale"] == want["unshuffle_scale"]
    assert got == want


def test_real_esrgan_x2_layout():
    """Real-ESRGAN's x2 generator: mrrdb_net at its own scale 4 behind an
    unshuffle by 2 of the 2x task: in_nc 12."""
    got, _ = _both(_opt(scale=2, use_unshuffle=True,
                        network_G={"type": "mrrdb_net", "scale": 4}))
    g = got["network_G"]
    assert (g["type"], g["in_nc"], g["upscale"], g["nf"], g["nb"],
            g["gc"]) == ("mrrdb_net", 12, 4, 64, 23, 32)
    assert got["unshuffle_scale"] == 2


D_SPECS = [
    {"type": "discriminator_vgg", "nf": 32, "size": 128},
    {"type": "discriminator_vgg", "nf": 32},
    {"which_model_D": "discriminator_vgg", "net_act": "swish",
     "G_arch": "PPON", "input_nc": 3, "mode": "NAC"},
    {"type": "discriminator_vgg_128", "base_nf": 16, "norm_type": "batch"},
    {"type": "discriminator_vgg_128_SN"},
    {"type": "discriminator_vgg_fea", "D_size": 96, "spectral_norm": True},
    {"type": "patchgan", "nf": 32, "nlayer": 4, "spectral_norm": True},
    {"type": "multiscale", "in_nc": 3, "num_D": 2},
    {"type": "pixeldiscriminator"},
    {"type": "unet", "nf": 32, "in_nc": 3},
    {"type": "discriminator_vgg", "nlayer": 3, "num_D": 3, "extra": "x"},
]


@pytest.mark.parametrize("spec", D_SPECS, ids=range(len(D_SPECS)))
def test_discriminator_specs_parse_as_in_jax(spec):
    assert get_network_D_config(copy.deepcopy(spec), 4, 128, "rrdb_net") == \
        jax_get_network_D_config(copy.deepcopy(spec), 4, 128, "rrdb_net")
    got, want = _both(_opt(network_D=spec))
    assert got["network_D"] == want["network_D"]


def test_discriminator_config_takes_nf_and_the_crop_size():
    """Before ``get_network_D_config`` was ported, ``network_D`` reached
    ``define_D`` raw: D-VGG with ``nf: 32`` was built with base_nf 64, and
    a D-VGG without ``size`` raised a TypeError. Both as in JAX now."""
    got = parse_dict(_opt(network_D={"type": "discriminator_vgg",
                                     "nf": 32, "size": 128}))
    assert got["network_D"]["base_nf"] == 32
    net = define_D(got)
    assert net.conv0_0.weight.shape[0] == 32
    got = parse_dict(_opt(network_D={"type": "discriminator_vgg",
                                     "nf": 32}))
    assert got["network_D"]["size"] == 128
    assert define_D(got).n_blocks == 5


def test_discriminator_nac_builds():
    """D-VGG in the NAC order (the norm over each conv's input)."""
    got = parse_dict(_opt(network_D={"type": "discriminator_vgg",
                                     "nf": 8, "size": 32, "mode": "NAC"}))
    net = define_D(got)
    assert net.conv0_1.mode == "NAC"
    assert net.conv0_1.norm.running_mean.shape == (8,)


def _uncommented(tmp_path):
    text = TRAIN_SR.read_text()
    for line in ("# use_cem: true", "# use_unshuffle: true",
                 "# unshuffle_scale: 4", "# plus: false"):
        assert line in text
        text = text.replace(line, line[2:])
    path = tmp_path / "train_sr_all.yml"
    path.write_text(text)
    return path


def test_train_sr_yml_with_its_options_uncommented(tmp_path):
    path = _uncommented(tmp_path)
    got = parse(str(path))
    want = jax_parse(str(path))
    assert got["use_cem"] and got["use_unshuffle"]
    assert got["network_G"]["plus"] is False
    assert got["network_G"]["in_nc"] == 48 and got["unshuffle_scale"] == 4
    assert got == want


@pytest.mark.parametrize("kind, item", [
    ("ppon", None), ("pan", None), ("sofvsr", None),
    ("dvd_net", None), ("edvr", None), ("srflow", None),
    ("wbcunet_net", None), ("abpn", None), ("asr_cnn", None),
    ("wbcunet_tf", None), ("no_such_net", "not recognized"),
])
def test_other_generators_raise_with_their_item(kind, item):
    """Every generator of the JAX table parses as the JAX package parses
    it: ``ppon`` and ``pan`` (ROADMAP Queue A 10.2), ``sofvsr`` and
    ``edvr`` (A 10.5), ``srflow``, ``abpn`` and ``asr_cnn`` (A 10.6 a and
    c), ``dvd_net`` and ``wbcunet_net`` / ``wbcunet_tf`` (A 10.6 b and d),
    each once refused here (``sft_arch`` and ``unet_128``, once cases
    here, are built since A 10.3 and A 10.4: ``test_torch_i2i_nets.py``,
    ``test_torch_sft.py``; the video nets: ``test_torch_video_nets.py``;
    SRFlow: ``test_torch_srflow.py``; DVD and WBC: ``test_torch_dvd.py``,
    ``test_torch_wbc.py``); a type the JAX table lacks raises."""
    if item is None:
        from trainner_tpu.options.defaults import \
            get_network_G_config as jax_config

        assert get_network_G_config({"type": kind}, 4) == \
            jax_config({"type": kind}, 4)
        return
    with pytest.raises(NotImplementedError, match=item):
        get_network_G_config({"type": kind}, 4)


def test_test_cli_serves_presets_and_unshuffle_as_the_jax_cli(tmp_path):
    """Both inference CLIs on ``network_G_preset: gen_esrgan`` with
    ``use_unshuffle`` at scale 2 (G at its own 4x, in_nc 12) and one flax
    ``.ckpt``: the same PNGs within one 8-bit level (f32)."""
    import json

    import cv2
    import jax
    import jax.numpy as jnp
    import numpy as np

    import test as jax_test_cli
    from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
    from trainner_tpu.utils.checkpoint import save_params
    from trainner_tpu_torch import test as port_test_cli

    net = JaxRRDBNet(in_nc=12, nf=16, nb=1, gc=8, upscale=4)
    v = net.init({"params": jax.random.PRNGKey(0),
                  "noise": jax.random.PRNGKey(0)},
                 jnp.zeros((1, 8, 8, 12)), train=False)
    draw = np.random.RandomState(7)
    params = jax.tree.map(
        lambda a: ((draw.randn(*a.shape) / np.sqrt(np.prod(a.shape[:3])))
                   if a.ndim == 4 else draw.randn(*a.shape) * 0.05
                   ).astype(np.float32), v["params"])
    ckpt = tmp_path / "G.ckpt"
    save_params(params, str(ckpt))
    for name in ("jax", "port"):
        opt = {"name": name, "model": "sr", "scale": 2,
               "use_unshuffle": True, "network_G_preset": "gen_esrgan",
               "network_G": {"scale": 4, "nf": 16, "nb": 1, "gc": 8},
               "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                       "crop_size": 32, "n_samples": 2}},
               "path": {"root": str(tmp_path),
                        "pretrain_model_G": str(ckpt)}}
        (tmp_path / f"{name}.json").write_text(json.dumps(opt))
    jax_test_cli.main(["-opt", str(tmp_path / "jax.json")])
    port_test_cli.main(["-opt", str(tmp_path / "port.json")], device="cpu")
    for i in range(2):
        a, b = (cv2.imread(str(tmp_path / "results" / run / "synth"
                               / f"{i}.png")) for run in ("jax", "port"))
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
