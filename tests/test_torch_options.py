"""The port's options (``trainner_tpu_torch/options/config.py``) against the
JAX package's: its own YAML reader against PyYAML with the JAX package's
loader, on every options file of the repo and on the YAML forms that
options use; ``*_rel`` schedules and the short frequencies of a ``debug``
name; ``check_resume`` and ``dict2str``."""

import copy
import pathlib
import subprocess
import sys

import pytest

from trainner_tpu.options.config import check_resume as jax_check_resume
from trainner_tpu.options.config import dict2str as jax_dict2str
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu.options.config import read_yaml as jax_read_yaml
from trainner_tpu_torch.options.config import (check_resume, dict2str,
                                               parse, parse_dict, read_yaml)

ROOT = pathlib.Path(__file__).resolve().parent.parent
YML = sorted((ROOT / "options").rglob("*.yml"))


def test_every_options_directory_has_yaml():
    assert len(YML) >= 14
    assert {p.parent.name for p in YML} >= {"sr", "i2i", "srflow", "video"}


@pytest.mark.parametrize("path", YML, ids=lambda p: str(p.relative_to(ROOT)))
def test_read_yaml_equals_pyyaml(path):
    got = read_yaml(str(path))
    assert got == jax_read_yaml(str(path))
    # the types too: 1 and 1.0 and True compare equal in Python
    assert repr(got) == repr(jax_read_yaml(str(path)))


YAML_FORMS = {
    "scalars": """
a: 1
b: 1.5
c: 1e-4
d: 5e3
e: -2.5E+2
f: 0o17
g: 017
h: 0x1F
i: 1_000
j: yes
k: Off
l: ~
m:
n: null
o: 'it''s'
p: "tab\\tq"
q: plain text # a comment
r: a#b
s: .inf
t: -.Inf
u: 12:30
v: 1.0
""",
    "collections": """
top:
  list: [1, two, 3.0, [4, 5], {six: 6}]
  map: {form: relativistic, w: 0.5}
  empty_list: []
  block:
    - 1
    - name: x
      val: [a, b]
    - - nested
  deeper:
    more:
      leaf: true
compact:
- one
- two
multi: [a,
  b, c]
""",
}


@pytest.mark.parametrize("form", sorted(YAML_FORMS))
def test_read_yaml_equals_pyyaml_on_the_forms_options_use(form, tmp_path):
    path = tmp_path / f"{form}.yml"
    path.write_text(YAML_FORMS[form])
    got, want = read_yaml(str(path)), jax_read_yaml(str(path))
    assert got == want
    assert repr(got) == repr(want)


def test_read_yaml_needs_no_pyyaml():
    """The reader runs where ``import yaml`` fails, as on the card's
    machine, and gives what PyYAML gives here."""
    path = ROOT / "options" / "sr" / "train_sr.yml"
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from trainner_tpu_torch.options.config import read_yaml\n"
            f"print(repr(read_yaml({str(path)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == repr(jax_read_yaml(str(path)))


@pytest.mark.parametrize("bad", ["a: &x 1\nb: *x\n", "a: |\n  text\n",
                                 "a: [1, 2\n"])
def test_read_yaml_refuses_what_it_does_not_read(bad, tmp_path):
    path = tmp_path / "bad.yml"
    path.write_text(bad)
    with pytest.raises(ValueError):
        read_yaml(str(path))


def _train_opt(name="001_sr", **train):
    return {"name": name, "model": "sr", "scale": 4,
            "network_G": {"type": "rrdb_net", "nf": 16, "nb": 2, "gc": 8},
            "train": {"niter": 1000, "lr_G": 1e-4, **train},
            "logger": {"print_freq": 200, "save_checkpoint_freq": 5000},
            "path": {"root": "/nonexistent"}}


@pytest.mark.parametrize("name, train", [
    ("001_sr", {"lr_steps_rel": [0.5, 0.75]}),
    ("001_sr", {"lr_steps_rel": [0.333], "warmup_iters_rel": 0.01,
                "val_freq": 50}),
    ("001_sr", {"lr_steps_rel": [0.5], "niter": 0}),
    ("debug_sr", {"lr_steps": [100]}),
    ("debug_nochkp_sr", {"lr_steps_rel": [0.25], "val_freq": 5000}),
])
def test_rel_schedules_and_debug_names_match_jax(name, train):
    """Checked on the parent too: ``lr_steps_rel`` [0.5, 0.75] of 1000
    iterations is [500, 750]; a ``debug`` name sets ``val_freq`` 8,
    ``print_freq`` 2 and ``save_checkpoint_freq`` 8 (10**8 with
    ``nochkp``)."""
    opt = _train_opt(name, **train)
    got = parse_dict(copy.deepcopy(opt))
    want = jax_parse_dict(copy.deepcopy(opt))
    assert got["train"] == want["train"]
    assert got["logger"] == want["logger"]
    assert got["is_debug"] == want["is_debug"]
    assert got["path"] == want["path"]
    if train.get("lr_steps_rel") == [0.5, 0.75]:
        assert got["train"]["lr_steps"] == [500, 750]
        assert "lr_steps_rel" not in got["train"]
    if name.startswith("debug"):
        assert got["train"]["val_freq"] == 8
        assert got["logger"]["print_freq"] == 2


def test_the_debug_config_parses_as_in_jax():
    path = str(ROOT / "options" / "sr" / "train_sr_debug.yml")
    got = parse(path)
    want = jax_parse_dict(jax_read_yaml(path), opt_path=path)
    for key in ("train", "logger", "path", "is_debug", "scale"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("resume", [None, "/exp/training_state"])
def test_check_resume_matches_jax(resume):
    opt = parse_dict(_train_opt(path={}))
    opt["path"]["resume_state"] = resume
    jopt = copy.deepcopy(opt)
    check_resume(opt, 12)
    jax_check_resume(jopt, 12)
    assert opt["path"] == jopt["path"]
    if resume:
        assert opt["path"]["pretrain_model_G"].endswith("models/12_G.ckpt")
        assert opt["path"]["pretrain_model_D"].endswith("models/12_D.ckpt")


def test_dict2str_matches_jax():
    opt = parse(str(ROOT / "options" / "sr" / "train_sr.yml"))
    assert dict2str(opt) == jax_dict2str(opt)
    assert "network_G:[" in dict2str(opt)


@pytest.mark.parametrize("key, value, item", [
    ("network_G", {"type": "ppon"}, None),
    ("network_G", {"type": "edvr"}, "Queue A 10.5"),
    ("network_G", {"type": "wbcunet"}, "Queue A 10.6")])
def test_options_outside_the_port_raise_with_their_item(key, value, item):
    """The network presets and ``use_unshuffle`` are parsed now
    (``test_torch_network_options.py``), and so are the realsr and combo
    strategies (``test_realsr_parses_like_jax``) and ``ppon`` (ROADMAP Queue
    A 10.2, its G config the JAX one); other generators still raise and
    name their ROADMAP item."""
    opt = _train_opt()
    opt[key] = value
    if item is None:
        got = parse_dict(copy.deepcopy(opt))
        assert got["network_G"] == jax_parse_dict(opt)["network_G"]
        assert got["network_D"] == jax_parse_dict(opt)["network_D"]
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        parse_dict(opt)


@pytest.mark.parametrize("strategy", ["realsr", "combo"])
def test_realsr_parses_like_jax(strategy):
    """``augs_strategy: realsr`` (and combo), which raised before their
    slice: the parsed options equal the JAX package's."""
    opt = _train_opt()
    opt["datasets"] = {"train": {"name": "t", "mode": "aligned",
                                 "dataroot_HR": "/x",
                                 "augs_strategy": strategy}}
    got = parse_dict(copy.deepcopy(opt))
    want = jax_parse_dict(copy.deepcopy(opt))
    assert got["datasets"] == want["datasets"]
    assert got["datasets"]["train"]["lr_noise"] is True
