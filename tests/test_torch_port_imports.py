"""The port stands alone: no module of ``trainner_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax or anything of the JAX package. Checked
twice: by scanning every import statement, and by importing every module in
a fresh interpreter that refuses those names (and the packages that the
machine with the card lacks: PyYAML, OpenCV, lmdb, msgpack; and triton, which
only a kernel's launch may import)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "trainner_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "trainner_tpu")
ABSENT_ON_CARD = ("yaml", "cv2", "lmdb", "msgpack", "triton")


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [(name, node.lineno) for name, node in _top_level_imports(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_modules_to_scan():
    names = {_module_name(p) for p in FILES}
    assert {"trainner_tpu_torch.ops.rdb5c", "trainner_tpu_torch.test",
            "trainner_tpu_torch.models.rrdb", "chip_smoke",
            "trainner_tpu_torch.models.discriminators",
            "trainner_tpu_torch.models.perceptual",
            "trainner_tpu_torch.losses.gan",
            "trainner_tpu_torch.losses.generator_loss",
            "trainner_tpu_torch.losses.perceptual",
            "trainner_tpu_torch.train.optimizers",
            "trainner_tpu_torch.train.schedulers",
            "trainner_tpu_torch.train.state",
            "trainner_tpu_torch.train.sr_trainer",
            "trainner_tpu_torch.options.presets",
            "trainner_tpu_torch.ops.imresize",
            "trainner_tpu_torch.ops.blur",
            "trainner_tpu_torch.ops.degradations",
            "trainner_tpu_torch.data.pipeline",
            "trainner_tpu_torch.data.common",
            "trainner_tpu_torch.data.datasets",
            "trainner_tpu_torch.data.loader",
            "trainner_tpu_torch.train.producer",
            "trainner_tpu_torch.ops.blocks",
            "trainner_tpu_torch.models.networks",
            "trainner_tpu_torch.utils.torch_interop",
            "trainner_tpu_torch.utils.checkpoint",
            "trainner_tpu_torch.train.cli",
            "trainner_tpu_torch.options.defaults",
            "trainner_tpu_torch.models.srresnet",
            "trainner_tpu_torch.ops.partial_conv",
            "trainner_tpu_torch.ops.cem",
            "trainner_tpu_torch.ops.filters",
            "trainner_tpu_torch.ops.colors",
            "trainner_tpu_torch.data.lmdb_io",
            "trainner_tpu_torch.data.host_degradations",
            "trainner_tpu_torch.data.host_superpixels",
            "trainner_tpu_torch.models.ppon",
            "trainner_tpu_torch.models.pan",
            "trainner_tpu_torch.train.ppon_trainer",
            "trainner_tpu_torch.scripts.create_lmdb",
            "trainner_tpu_torch.utils.pth_convert"} <= names
    # the user tools (ROADMAP Queue A 12), each scanned and imported above
    tools = ("net_interp", "dir_interp", "net_splice", "swa2normal",
             "transfer_params", "convert_torch_model", "calculate_psnr_ssim",
             "generate_mod_lr_bic", "extract_subimgs", "color2gray",
             "back_projection", "lmdb2tpak", "test_dataloader")
    assert {f"trainner_tpu_torch.scripts.{t}" for t in tools} <= names


_GUARD = """
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in {modules!r}:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("imported", len({modules!r}))
"""


def test_every_module_imports_without_jax_or_card_absent_packages():
    modules = sorted(_module_name(p) for p in FILES)
    code = _GUARD.format(blocked=FORBIDDEN + ABSENT_ON_CARD, modules=modules)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"imported {len(modules)}" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where no
    card is present."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['chip_smoke.py']; import runpy; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
