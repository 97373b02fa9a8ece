"""The port's degradation presets and train-dataset options
(``trainner_tpu_torch/options/presets``, ``options/config.py``) against the
JAX package's: the JSON copies of the preset files equal the YAML files,
the overlay gives the same dataset options key for key, and the stage
parameters split from them are the same. Everything here is exact.
"""

import copy
import json
import os

import pytest
import yaml

from trainner_tpu.data import pipeline as JP
from trainner_tpu.options import presets as jax_presets
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import pipeline as P
from trainner_tpu_torch.options import presets
from trainner_tpu_torch.options.config import (INTERP_CODES, _algo2int,
                                               parse_dict)

PRESETS = ("base_blur", "base_noise", "base_resize", "bsrgan_blur",
           "bsrgan_noise", "bsrgan_resize", "resrgan_blur", "resrgan_noise",
           "resrgan_resize", "realsr_noise", "realsr_resize", "combo_blur",
           "combo_noise", "combo_resize", "gen_esrgan", "disc_esrgan")
JAX_DIR = os.path.dirname(jax_presets.__file__)
PORT_DIR = os.path.dirname(presets.__file__)


def _e2e_options(**dataset):
    """The options of the end-to-end training benchmark (bench.py:155)."""
    return {
        "is_train": True, "scale": 4, "model": "sr",
        "datasets": {"train": {
            "name": "bench", "mode": "aligned", "dataroot_HR": "/nonexistent",
            "crop_size": 128, "batch_size": 32, "use_flip": True,
            "use_rot": True, "augs_strategy": "bsrgan",
            "resize_strat": "in", "n_workers": 4, "wire_dtype": "uint8",
            "shuffle_degradations": False, **dataset}},
        "network_G": {"type": "rrdb_net", "nf": 64, "nb": 23, "gc": 32,
                      "upscale": 4},
        "network_D": {"type": "discriminator_vgg", "size": 128,
                      "base_nf": 64},
        "train": {"lr_G": 1e-4, "lr_D": 1e-4, "pixel_criterion": "l1",
                  "pixel_weight": 1e-2, "feature_criterion": "l1",
                  "feature_weight": 1.0, "gan_type": "vanilla",
                  "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                  "lr_steps": [50000]},
    }


def _both(**dataset):
    opt = _e2e_options(**dataset)
    return (parse_dict(copy.deepcopy(opt), is_train=True),
            jax_parse_dict(copy.deepcopy(opt), is_train=True))


@pytest.mark.parametrize("name", PRESETS)
def test_json_preset_equals_the_yaml_file(name):
    with open(os.path.join(JAX_DIR, name + ".yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(PORT_DIR, name + ".json")) as f:
        got = json.load(f)
    assert got == want
    assert presets.load_preset(name) == jax_presets.load_preset(name)


def test_only_the_ported_presets_are_in_the_package():
    found = sorted(f[:-5] for f in os.listdir(PORT_DIR) if f.endswith(".json"))
    assert found == sorted(PRESETS)


def test_resolved_train_dataset_equals_jax_key_for_key():
    got, want = _both()
    ds_g, ds_w = got["datasets"]["train"], want["datasets"]["train"]
    assert set(ds_g) == set(ds_w)
    for k in ds_w:
        assert ds_g[k] == ds_w[k], k
    assert ds_g["shuffle_degradations"] is False  # inline wins over true
    assert ds_g["lr_downscale_types"] == [997, 773, 777, 998]
    assert ds_g["down_up_types"] == ds_g["final_scale_types"] == [773, 777]
    assert ds_g["virtual_batch_size"] == 32
    assert got["network_G"] == want["network_G"]


def test_inline_keys_win_over_both_presets():
    inline = {"aug_configs": {"iso": {"kernel_size": 9},
                              "jpeg": {"p": 1.0}},
              "lr_noise_types": ["jpeg"], "blur_prob": 0.5,
              "HR_size": 96, "crop_size": None, "batch_size": 8,
              "virtual_batch_size": 4}
    got, want = _both(**inline)
    ds_g, ds_w = got["datasets"]["train"], want["datasets"]["train"]
    assert ds_g == ds_w
    assert ds_g["aug_configs"]["iso"]["kernel_size"] == 9
    assert ds_g["aug_configs"]["iso"]["sigmaX"] == [0.1, 2.8]  # the preset's
    assert ds_g["aug_configs"]["jpeg"] == {"p": 1.0, "min_quality": 30,
                                           "max_quality": 95}
    assert ds_g["lr_noise_types"] == ["jpeg"] and ds_g["blur_prob"] == 0.5
    assert ds_g["crop_size"] == 96       # the HR_size alias
    assert ds_g["virtual_batch_size"] == 8  # never below the batch size


def test_a_dataset_without_presets_is_left_alone():
    got, want = _both(augs_strategy=None)
    assert got["datasets"]["train"] == want["datasets"]["train"]
    assert "aug_configs" not in got["datasets"]["train"]


def test_unpaired_params_equal_jax():
    got, want = _both()
    lr_g, hr_g = P.get_unpaired_params(got["datasets"]["train"])
    lr_w, hr_w = JP.get_unpaired_params(want["datasets"]["train"])
    assert lr_g == lr_w and hr_g == hr_w == {}
    assert list(lr_g) == list(lr_w)
    assert lr_g["blur"] == {"prob": 1.0, "types": ["iso"], "weights": None}
    assert lr_g["compression"]["types"] == ["jpeg"]
    assert "random_shuffle" not in lr_g
    shuffled, _ = P.get_unpaired_params(
        dict(got["datasets"]["train"], shuffle_degradations=True))
    assert shuffled["random_shuffle"] is True


def test_weighted_types_and_disabled_stages_split_as_in_jax():
    ds = {"lr_blur": True, "lr_blur_types": {"iso": 3, "aniso": 1},
          "lr_noise": False, "lr_noise_types": ["gaussian"],
          "compression": ["jpeg"], "hr_noise": True,
          "hr_noise_types": "gaussian", "resize_strat": "pre",
          "lr_downscale": True, "lr_downscale_types": [777]}
    assert P.get_unpaired_params(ds) == JP.get_unpaired_params(ds)
    lr, hr = P.get_unpaired_params(ds)
    assert lr["blur"]["types"] == ["iso", "aniso"]
    assert lr["blur"]["weights"] == [3.0, 1.0]
    assert "noise" not in lr and "resize" not in lr
    assert hr["noise"]["types"] == ["gaussian"] and hr["kind"] == "hr"


def test_batch_degrader_stage_and_final_names_equal_jax():
    got, want = _both()
    port = P.BatchDegrader(got["datasets"]["train"], "lr")
    ref = JP.BatchDegrader(want["datasets"]["train"], "lr")
    assert [n for n, _ in port.stages] == [n for n, _ in ref.stages] \
        == ["blur", "resize", "noise", "compression", "blur2", "noise2"]
    assert [n for n, _ in port.finals] == [n for n, _ in ref.finals] \
        == ["final_scale", "final_compression"]
    # the same stages carry a plain and an attenuated variant
    assert [n for n, f in port.stages if isinstance(f, dict)] \
        == [n for n, f in ref.stages if isinstance(f, dict)] \
        == ["noise", "compression", "blur2", "noise2"]


def test_interp_codes_equal_jax():
    from trainner_tpu.options import config as jax_config

    assert INTERP_CODES == jax_config.INTERP_CODES
    assert _algo2int(["Cubic", "nearest_aligned", 5, "unknown"]) \
        == jax_config._algo2int(["Cubic", "nearest_aligned", 5, "unknown"]) \
        == [777, 997, 5, "unknown"]


@pytest.mark.parametrize("strategy", ["realsr", "combo"])
def test_another_strategy_raises_and_names_its_item(strategy):
    """The strategies that raised before their slice (ROADMAP Queue A 5.2)
    resolve as the JAX package's now, key for key, and split into the same
    stage parameters (realsr has no blur preset: both skip it)."""
    got, want = _both(augs_strategy=strategy)
    ds_g, ds_w = got["datasets"]["train"], want["datasets"]["train"]
    assert ds_g == ds_w
    assert P.get_unpaired_params(ds_g) == JP.get_unpaired_params(ds_w)
    assert ("lr_blur" in ds_g) == (strategy == "combo")


def test_resrgan_resolves_like_jax():
    """``augs_strategy: resrgan``: the resolved train dataset equals the
    JAX package's key for key: the weighted blur types with sinc in both
    cycles, the sinc final blur, poisson beside gaussian noise, and the
    cv2 area code 3 among the resize types."""
    got, want = _both(augs_strategy="resrgan")
    ds_g, ds_w = got["datasets"]["train"], want["datasets"]["train"]
    assert ds_g == ds_w
    assert ds_g["lr_blur_types"] == ds_g["lr_blur_types2"] == {
        "aniso": 0.32, "iso": 0.58, "sinc": 0.1}
    assert ds_g["final_blur"] == ["sinc"] and ds_g["final_blur_prob"] == 0.8
    assert ds_g["lr_noise_types"] == ["gaussian", "poisson"]
    assert ds_g["lr_downscale_types"] == [3, 773, 777]
    assert ds_g["aug_configs"]["sinc2"]["min_kernel_size"] == 7


def test_a_missing_preset_file_raises():
    with pytest.raises(FileNotFoundError, match="nonexistent_blur"):
        parse_dict(_e2e_options(add_blur_preset="nonexistent_blur"),
                   is_train=True)
