"""The port's user tools (``trainner_tpu_torch/scripts/``) against their
JAX originals (``scripts/*.py``, run in this process as
``tests/test_scripts.py::_run_script`` runs them) on seeded checkpoints,
images, ``.pth`` state dicts made here and an LMDB that
``data/lmdb_io.py::write_lmdb`` writes:

- checkpoints and ``.tpak`` files equal byte for byte, or leaf for leaf
  (every path, type, shape and value) where the msgpack orders differ;
  npz and ``.pth`` files array for array;
- host images equal bit for bit (their pixels);
- ``back_projection`` within 1e-5 of the JAX computation (on the CPU
  here; the tool runs on the card unless ``--device cpu``);
- PSNR / SSIM within 1e-6 relative;
- ``test_dataloader``'s undegraded batches equal to the JAX tool's, and
  its degraded ones equal to the port's own producer under the same seed
  (the two packages' draws differ, ROADMAP C 9).
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from trainner_tpu_torch.data.common import decode_image, save_img
from trainner_tpu_torch.utils.checkpoint import msgpack_restore

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax(name, argv, monkeypatch):
    """The JAX package's ``scripts/{name}.py`` in this process."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    return mod.main()


def run_port(name, argv, **kw):
    mod = importlib.import_module(f"trainner_tpu_torch.scripts.{name}")
    return mod.main(list(argv), **kw)


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, pre + (k,)))
        return out
    return {pre: tree}


def same_file(a, b):
    """Two msgpack files: equal bytes, or equal leaves by path."""
    with open(a, "rb") as f:
        da = f.read()
    with open(b, "rb") as f:
        db = f.read()
    if da == db:
        return
    fa, fb = _flat(msgpack_restore(da)), _flat(msgpack_restore(db))
    assert set(fa) == set(fb)
    for k, v in fa.items():
        w = fb[k]
        assert type(v) is type(w), k
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


def same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert set(za.files) == set(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k


def same_images(da, db):
    """Every image of two folders, by relative path: equal pixels."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    assert files(da) == files(db) and files(da)
    for f in files(da):
        a = decode_image(os.path.join(da, f))
        b = decode_image(os.path.join(db, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"conv0": {"kernel": rng.normal(size=(3, 3, 4, 8))
                      .astype(np.float32),
                      "bias": rng.normal(size=(8,)).astype(np.float32)},
            "body": {"conv1": {"kernel": rng.normal(size=(1, 1, 8, 8))
                               .astype(np.float32)},
                     "a_norm": {"scale": rng.random(8).astype(np.float32)}},
            "head": {"kernel": rng.normal(size=(3, 3, 8, 3))
                     .astype(np.float32)}}


@pytest.fixture()
def ckpts(tmp_path):
    from trainner_tpu.utils.checkpoint import save_params

    paths = []
    for i in range(3):
        p = str(tmp_path / f"m{i}.ckpt")
        save_params(_params(i), p, backup=False)
        paths.append(p)
    return paths, tmp_path


@pytest.mark.parametrize("alpha", ["0.8", "0.3"])
def test_net_interp(ckpts, monkeypatch, alpha):
    (a, b, _), tmp = ckpts
    run_jax("net_interp", [a, b, str(tmp / "j.ckpt"), "--alpha", alpha],
            monkeypatch)
    run_port("net_interp", [a, b, str(tmp / "p.ckpt"), "--alpha", alpha])
    same_file(tmp / "j.ckpt", tmp / "p.ckpt")


@pytest.mark.parametrize("how", [["-i", "0.4"], ["-s", "0.5", "--seed",
                                                 "3"]])
def test_net_splice(ckpts, monkeypatch, how):
    (a, b, _), tmp = ckpts
    run_jax("net_splice", [a, b, str(tmp / "j.ckpt")] + how, monkeypatch)
    run_port("net_splice", [a, b, str(tmp / "p.ckpt")] + how)
    same_file(tmp / "j.ckpt", tmp / "p.ckpt")


def test_dir_interp(ckpts, monkeypatch):
    _, tmp = ckpts
    run_jax("dir_interp", ["--intdir", str(tmp), "--savepath",
                           str(tmp.parent / "j.ckpt")], monkeypatch)
    run_port("dir_interp", ["--intdir", str(tmp), "--savepath",
                            str(tmp.parent / "p.ckpt")])
    same_file(tmp.parent / "j.ckpt", tmp.parent / "p.ckpt")


def test_transfer_params(ckpts, monkeypatch):
    from trainner_tpu.utils.checkpoint import save_params

    (a, _, _), tmp = ckpts
    dst = _params(9)
    dst["extra"] = {"kernel": np.ones((1, 1, 8, 3), np.float32)}
    dst["renamed"] = {"conv1": {"kernel": np.zeros((1, 1, 8, 8),
                                                   np.float32)}}
    dpath = str(tmp / "fresh.ckpt")
    save_params(dst, dpath, backup=False)
    argv = [a, dpath, None, "--map", "body=renamed"]
    run_jax("transfer_params", argv[:2] + [str(tmp / "j.ckpt")] + argv[3:],
            monkeypatch)
    run_port("transfer_params", argv[:2] + [str(tmp / "p.ckpt")] + argv[3:])
    same_file(tmp / "j.ckpt", tmp / "p.ckpt")


def _esrgan_sd(nb=2, nf=8, gc=4, seed=0, old=False):
    """A reference ESRGAN state dict (x4: two upconvs) of random f32
    tensors, in the named or the old Sequential layout."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k=3):
        return {"weight": torch.from_numpy(rng.normal(
            size=(o, i, k, k)).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(size=(o,))
                                     .astype(np.float32))}
    sd = {}

    def put(name, d):
        sd.update({f"{name}.{k}": v for k, v in d.items()})

    if not old:
        put("conv_first", conv(nf, 3))
        for i in range(nb):
            for r in range(1, 4):
                for c in range(1, 6):
                    put(f"RRDB_trunk.{i}.RDB{r}.conv{c}",
                        conv(gc if c < 5 else nf, nf + (c - 1) * gc))
        for name in ("trunk_conv", "upconv1", "upconv2", "HRconv"):
            put(name, conv(nf, nf))
        put("conv_last", conv(3, nf))
        return sd
    put("model.0", conv(nf, 3))
    for i in range(nb):
        for r in range(1, 4):
            for c in range(1, 6):
                put(f"model.1.sub.{i}.RDB{r}.conv{c}.0",
                    conv(gc if c < 5 else nf, nf + (c - 1) * gc))
    put(f"model.1.sub.{nb}", conv(nf, nf))
    for idx in (3, 6, 8):
        put(f"model.{idx}", conv(nf, nf))
    put("model.10", conv(3, nf))
    return sd


def _srresnet_sd(nb=2, nf=8, seed=1):
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.normal(size=(o, i, 3, 3)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.normal(size=(o,)).astype(np.float32))

    conv("model.0", nf, 3)
    for i in range(nb):
        conv(f"model.1.sub.{i}.res.0", nf, nf)
        conv(f"model.1.sub.{i}.res.2", nf, nf)
    conv(f"model.1.sub.{nb}", nf, nf)
    for idx in (2, 5):
        conv(f"model.{idx}", nf * 4, nf)
    conv("model.8", nf, nf)
    conv("model.10", 3, nf)
    return sd


def _dvgg_sd(seed=2):
    """Discriminator_VGG_128's layout at base_nf 4: ten convs, a BN after
    each but the first, two linears (the first over 8 x 4 x 4)."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for n in range(10):
        cout = 4 * 2 ** min(n // 2 + (n % 2 and n < 2), 3)
        k = 3 if n % 2 == 0 else 4
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(size=(cout, cin, k, k)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(size=(cout,)).astype(np.float32))
        idx += 1
        if n:
            for leaf, fill in (("weight", 1.0), ("bias", 0.0),
                               ("running_mean", 0.1), ("running_var", 2.0)):
                sd[f"features.{idx}.{leaf}"] = torch.from_numpy(
                    (fill + rng.random(cout)).astype(np.float32))
            sd[f"features.{idx}.num_batches_tracked"] = torch.tensor(5)
            idx += 1
        idx += 1  # the activation
        cin = cout
    sd["classifier.0.weight"] = torch.from_numpy(
        rng.normal(size=(16, cin * 4 * 4)).astype(np.float32))
    sd["classifier.0.bias"] = torch.zeros(16)
    sd["classifier.2.weight"] = torch.from_numpy(
        rng.normal(size=(1, 16)).astype(np.float32))
    sd["classifier.2.bias"] = torch.zeros(1)
    return sd


def _keys_sd(keys, seed, conv_shape=(4, 4, 3, 3)):
    """Random f32 tensors under ``keys``: conv-shaped weights, vector
    biases."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(
        size=conv_shape if k.endswith("weight") else conv_shape[:1])
        .astype(np.float32)) for k in keys}


def _ppon_sd():
    keys = ["CFEM.0.weight", "CFEM.0.bias", "CFEM.1.sub.2.weight",
            "CFEM.1.sub.2.bias"]
    for i in range(2):
        for c in ("c1", "d1", "c2"):
            keys += [f"CFEM.1.sub.{i}.RB1.{c}.weight",
                     f"CFEM.1.sub.{i}.RB1.{c}.bias"]
    for fem in ("SFEM", "PFEM"):
        for i in range(2):
            keys += [f"{fem}.{i}.RB1.c1.weight", f"{fem}.{i}.RB1.c1.bias"]
    for rm in ("CRM", "SRM", "PRM"):
        for idx in (0, 3, 5, 7):
            keys += [f"{rm}.{idx}.weight", f"{rm}.{idx}.bias"]
    return _keys_sd(keys, 3)


def _sofvsr_sd():
    keys = []
    for prefix in ("OFR.RNN1.0", "OFR.RNN2.0", "OFR.SR.1", "OFR.SR.4",
                   "OFR.SR.7", "SR.body.0", "SR.body.3", "SR.body.6",
                   "SR.body.9"):
        keys += [f"{prefix}.weight", f"{prefix}.bias"]
    for body in ("OFR.RNN1.2", "OFR.SR.0", "SR.body.2"):
        for i in range(2):
            for j in (0, 2, 3):
                keys += [f"{body}.body.{i}.body.{j}.weight",
                         f"{body}.body.{i}.body.{j}.bias"]
    return _keys_sd(keys, 4)


@pytest.mark.parametrize("kind", ["esrgan", "esrgan_old", "srresnet",
                                  "discriminator", "ppon", "sofvsr"])
def test_convert_torch_model_ckpts(kind, tmp_path, monkeypatch):
    sd = {"esrgan": lambda: _esrgan_sd(),
          "esrgan_old": lambda: _esrgan_sd(old=True),
          "srresnet": _srresnet_sd, "discriminator": _dvgg_sd,
          "ppon": _ppon_sd, "sofvsr": _sofvsr_sd}[kind]()
    src = str(tmp_path / "in.pth")
    torch.save({"state_dict": sd} if kind == "esrgan" else sd, src)
    tool_kind = kind.replace("_old", "")
    run_jax("convert_torch_model", [tool_kind, src, str(tmp_path / "j.ckpt")],
            monkeypatch)
    run_port("convert_torch_model", [tool_kind, src,
                                     str(tmp_path / "p.ckpt")])
    same_file(tmp_path / "j.ckpt", tmp_path / "p.ckpt")


def test_convert_torch_model_export(tmp_path, monkeypatch):
    """An RRDBNet ``.ckpt`` back to the reference layout: the same
    tensors, and the round trip gives the state dict it came from."""
    sd = _esrgan_sd()
    src = str(tmp_path / "in.pth")
    torch.save(sd, src)
    ck = str(tmp_path / "g.ckpt")
    run_port("convert_torch_model", ["esrgan", src, ck])
    run_jax("convert_torch_model", ["export", ck, str(tmp_path / "j.pth"),
                                    "--nb", "2"], monkeypatch)
    run_port("convert_torch_model", ["export", ck, str(tmp_path / "p.pth"),
                                     "--nb", "2"])
    got = torch.load(tmp_path / "p.pth", weights_only=True)
    want = torch.load(tmp_path / "j.pth", weights_only=True)
    assert set(got) == set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(got[k], sd[k]), k


def _vgg_sd():
    rng = np.random.default_rng(5)
    sd, cin = {}, 3
    for n, idx in enumerate((0, 3, 6, 8, 11, 13, 16, 18)):
        cout = 4 * (n + 1)
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(size=(cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(size=(cout,)).astype(np.float32))
        cin = cout
    return sd


def _lin_sd():
    rng = np.random.default_rng(6)
    return {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate((4, 8, 16))}


def _squeeze_sd():
    rng = np.random.default_rng(7)
    sd = {}
    for prefix, _ in __import__(
            "trainner_tpu_torch.scripts.convert_torch_model",
            fromlist=["x"])._LPIPS_BACKBONE_MAPS["squeeze"]:
        sd[f"{prefix}.weight"] = torch.from_numpy(
            rng.normal(size=(4, 4, 3, 3)).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            rng.normal(size=(4,)).astype(np.float32))
    return sd


@pytest.mark.parametrize("kind", ["vgg", "lpips", "lpips-full"])
def test_convert_torch_model_npz(kind, tmp_path, monkeypatch):
    sd = {"vgg": _vgg_sd, "lpips": _lin_sd, "lpips-full": _squeeze_sd}[kind]()
    src = str(tmp_path / "in.pth")
    torch.save(sd, src)
    extra = []
    if kind == "lpips-full":
        torch.save(_lin_sd(), str(tmp_path / "lin.pth"))
        extra = ["--net", "squeeze", "--lin", str(tmp_path / "lin.pth")]
    run_jax("convert_torch_model", [kind, src, str(tmp_path / "j.npz")]
            + extra, monkeypatch)
    run_port("convert_torch_model", [kind, src, str(tmp_path / "p.npz")]
             + extra)
    same_npz(tmp_path / "j.npz", tmp_path / "p.npz")


def test_swa2normal(ckpts, monkeypatch):
    """From a training state's ``swa_params`` the same file as the JAX
    tool's; from a torch SWA ``.pth`` (``n_averaged``, ``module.``
    keys) the ESRGAN conversion of the unwrapped weights."""
    from flax import serialization

    _, tmp = ckpts
    state = str(tmp / "latest.state")
    with open(state, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"state": {"swa_params": _params(4), "swa_n": np.int32(7)}}))
    run_jax("swa2normal", [state, str(tmp / "j.ckpt")], monkeypatch)
    run_port("swa2normal", [state, str(tmp / "p.ckpt")])
    same_file(tmp / "j.ckpt", tmp / "p.ckpt")
    sd = _esrgan_sd()
    torch.save({"n_averaged": torch.tensor(3),
                **{f"module.{k}": v for k, v in sd.items()}},
               str(tmp / "swa.pth"))
    torch.save(sd, str(tmp / "plain.pth"))
    run_port("swa2normal", [str(tmp / "swa.pth"), str(tmp / "p2.ckpt")])
    run_jax("convert_torch_model", ["esrgan", str(tmp / "plain.pth"),
                                    str(tmp / "j2.ckpt")], monkeypatch)
    same_file(tmp / "j2.ckpt", tmp / "p2.ckpt")


def _image_folder(root, n=3, hw=(40, 36), seed=0, grey_one=True):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.random((n, 5, 5, 3))
    for i in range(n):
        k = -(-max(hw) // 5)
        img = np.kron(base[i], np.ones((k, k, 1)))[:hw[0], :hw[1]]
        img = np.clip(img + 0.1 * rng.random((*hw, 3)), 0, 1)
        img = (img * 255).astype(np.uint8)
        if grey_one and i == n - 1:
            img = img[:, :, 1]
        save_img(img, os.path.join(root, f"im{i}.png"))
    return root


def test_generate_mod_lr_bic(tmp_path, monkeypatch):
    src = _image_folder(str(tmp_path / "src"), grey_one=False)
    run_jax("generate_mod_lr_bic", [src, str(tmp_path / "j"), "--scale",
                                    "4"], monkeypatch)
    run_port("generate_mod_lr_bic", [src, str(tmp_path / "p"), "--scale",
                                     "4"])
    same_images(str(tmp_path / "j"), str(tmp_path / "p"))


def test_extract_subimgs(tmp_path, monkeypatch):
    src = _image_folder(str(tmp_path / "src"), grey_one=False)
    argv = ["--crop_size", "16", "--step", "8", "--threshold", "20"]
    run_jax("extract_subimgs", [src, str(tmp_path / "j")] + argv,
            monkeypatch)
    run_port("extract_subimgs", [src, str(tmp_path / "p")] + argv)
    same_images(str(tmp_path / "j"), str(tmp_path / "p"))


def test_color2gray(tmp_path, monkeypatch):
    src = _image_folder(str(tmp_path / "src"))
    run_jax("color2gray", [src, str(tmp_path / "j"), "--workers", "1"],
            monkeypatch)
    run_port("color2gray", [src, str(tmp_path / "p"), "--workers", "1"])
    same_images(str(tmp_path / "j"), str(tmp_path / "p"))


def test_calculate_psnr_ssim(tmp_path, monkeypatch, capsys):
    gt = _image_folder(str(tmp_path / "gt"), grey_one=False)
    sr = _image_folder(str(tmp_path / "sr"), seed=1, grey_one=False)
    os.rename(os.path.join(sr, "im1.png"), os.path.join(sr, "im1_rlt.png"))
    run_jax("calculate_psnr_ssim", [gt, sr], monkeypatch)
    want = capsys.readouterr().out
    got = run_port("calculate_psnr_ssim", [gt, sr])
    mine = capsys.readouterr().out
    nums = [[float(x) for x in re.findall(r"-?\d+\.\d+", line)]
            for line in want.splitlines()]
    assert len(want.splitlines()) == len(mine.splitlines()) == 5
    for line, w in zip(mine.splitlines(), nums):
        g = [float(x) for x in re.findall(r"-?\d+\.\d+", line)]
        np.testing.assert_allclose(g, w, rtol=1e-6)
    # the averages unrounded, against the JAX package's MetricsDict
    from trainner_tpu.data.common import read_img
    from trainner_tpu.utils.metrics import MetricsDict

    for tag, only_y in (("RGB", False), ("Y", True)):
        m = MetricsDict("psnr,ssim")
        for name, other in (("im0", "im0"), ("im1", "im1_rlt"),
                            ("im2", "im2")):
            m.calculate_metrics(read_img(os.path.join(sr, other + ".png")),
                                read_img(os.path.join(gt, name + ".png")),
                                crop_size=4, only_y=only_y)
        for a in m.get_averages():
            np.testing.assert_allclose(got[tag][a["name"]], a["average"],
                                       rtol=1e-6)


def _jax_back_projection(sr, lr, mode, iters, scale):
    """The JAX tool's computation (``scripts/back_projection.py``) on
    NHWC f32 arrays, without its rounding to 8 bits."""
    import jax
    import jax.numpy as jnp

    from trainner_tpu.ops.imresize import imresize

    spec = importlib.util.spec_from_file_location(
        "bp_jax", os.path.join(REPO, "scripts", "back_projection.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = jnp.asarray(mod._gauss_p())[:, :, None, None]
    sr, lr = jnp.asarray(sr), jnp.asarray(lr)
    for _ in range(iters):
        if mode == "bp":
            down = imresize(sr, out_shape=lr.shape[1:3], kernel="cubic")
            diff = imresize(lr - down, out_shape=sr.shape[1:3],
                            kernel="cubic")
            c = diff.shape[-1]
            dn = jax.lax.conv_dimension_numbers(
                diff.shape, (5, 5, 1, c), ("NHWC", "HWIO", "NHWC"))
            sr = sr + jax.lax.conv_general_dilated(
                diff, jnp.tile(p, (1, 1, 1, c)), (1, 1), "SAME", (1, 1),
                (1, 1), dn, feature_group_count=c)
        else:
            j = imresize(lr, float(scale), kernel="cubic")
            up = imresize(imresize(sr, 1.0 / scale, kernel="cubic"),
                          float(scale), kernel="cubic")
            sr = sr + (j - up)
    return np.asarray(sr)


@pytest.mark.parametrize("mode,iters", [("bp", 6), ("if", 3)])
def test_back_projection(tmp_path, monkeypatch, mode, iters):
    """The port's refinement within 1e-5 of the JAX tool's computation;
    the images both tools write equal but where that difference rounds
    across a level (by one level, at most a few pixels)."""
    from trainner_tpu.ops.imresize import imresize_np
    from trainner_tpu_torch.scripts.back_projection import back_project

    rng = np.random.default_rng(0)
    hr = rng.random((48, 48, 3)).astype(np.float32)
    lr = np.clip(imresize_np(hr, 0.25, kernel="cubic"), 0, 1)
    sr0 = np.clip(imresize_np(lr, 4.0, kernel="linear"), 0, 1)
    for d in ("lr", "sr"):
        os.makedirs(tmp_path / d)
    save_img((lr * 255).astype(np.uint8), str(tmp_path / "lr" / "a.png"))
    save_img((sr0 * 255).astype(np.uint8), str(tmp_path / "sr" / "a.png"))
    lr8 = decode_image(str(tmp_path / "lr" / "a.png"))[None] / 255.0
    sr8 = decode_image(str(tmp_path / "sr" / "a.png"))[None] / 255.0
    lr8, sr8 = lr8.astype(np.float32), sr8.astype(np.float32)
    want = _jax_back_projection(sr8, lr8, mode, iters, 4)
    got = back_project(torch.from_numpy(sr8), torch.from_numpy(lr8), mode,
                       iters, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    argv = ["--lr", str(tmp_path / "lr"), "--sr", str(tmp_path / "sr"),
            "--mode", mode, "--iters", str(iters)]
    run_jax("back_projection", argv + ["--out", str(tmp_path / "j")],
            monkeypatch)
    run_port("back_projection", argv + ["--out", str(tmp_path / "p"),
                                        "--device", "cpu"])
    a = decode_image(str(tmp_path / "j" / "a.png")).astype(int)
    b = decode_image(str(tmp_path / "p" / "a.png")).astype(int)
    assert np.abs(a - b).max() <= 1 and (a != b).sum() <= 4


def test_back_projection_runs_on_the_card_unless_asked(monkeypatch,
                                                       tmp_path):
    """No ``--device``: the card, and without one it raises rather than
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for d in ("lr", "sr"):
        os.makedirs(tmp_path / d)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_port("back_projection", ["--lr", str(tmp_path / "lr"), "--sr",
                                     str(tmp_path / "sr"), "--out",
                                     str(tmp_path / "o")])


def test_lmdb2tpak(tmp_path, monkeypatch):
    """An LMDB of PNGs (colour and grey) written by ``write_lmdb``: the
    port's ``.tpak`` equals the JAX tool's byte for byte, or entry for
    entry by key and pixels."""
    from trainner_tpu.data.packed import PackedReader as JaxReader
    from trainner_tpu_torch.data.common import encode_png
    from trainner_tpu_torch.data.lmdb_io import write_lmdb

    src = _image_folder(str(tmp_path / "imgs"), n=4)
    items = {}
    for f in sorted(os.listdir(src)):
        with open(os.path.join(src, f), "rb") as fh:
            items[os.path.splitext(f)[0].encode()] = fh.read()
    items[b"rgba"] = encode_png(np.full((6, 5, 4), 77, np.uint8))
    write_lmdb(str(tmp_path / "d.lmdb"), items)
    run_jax("lmdb2tpak", [str(tmp_path / "d.lmdb"), str(tmp_path / "j.tpak")],
            monkeypatch)
    n = run_port("lmdb2tpak", [str(tmp_path / "d.lmdb"),
                               str(tmp_path / "p.tpak")])
    assert n == 5
    with open(tmp_path / "j.tpak", "rb") as f:
        jb = f.read()
    with open(tmp_path / "p.tpak", "rb") as f:
        pb = f.read()
    if jb != pb:
        a, b = (JaxReader(str(tmp_path / "j.tpak")),
                JaxReader(str(tmp_path / "p.tpak")))
        assert a.keys == b.keys
        for k in a.keys:
            assert np.array_equal(a.read(k), b.read(k)), k


def _dl_options(tmp_path, hr_dir, degrade: bool) -> str:
    """``train_sr.yml`` with its train set on ``hr_dir``, batch 2;
    ``degrade``: its shuffled bsrgan strategy at crop 96, else no
    degradation (LR made on the host) at crop 32 without flips or
    rotations: the images are 32 px, so the crops and the batches are
    the seeded shuffle's alone (the datasets' own draws are unseeded in
    both packages)."""
    with open(os.path.join(REPO, "options", "sr", "train_sr.yml")) as f:
        text = f.read()
    text = text.replace("dataroot_HR: /data/DIV2K/HR", f"dataroot_HR: "
                        f"{hr_dir}", 1)
    text = text.replace("crop_size: 128",
                        f"crop_size: {96 if degrade else 32}", 1)
    text = text.replace("batch_size: 32", "batch_size: 2", 1)
    text = text.replace("n_workers: 4", "n_workers: 1", 1)
    if degrade:
        text = text.replace("    # shuffle_degradations: true",
                            "    shuffle_degradations: true", 1)
    else:
        text = text.replace("    augs_strategy: bsrgan", "", 1)
        text = text.replace("    lr_downscale: true", "", 1)
        text = text.replace("    use_flip: true\n    use_rot: true",
                            "    use_flip: false\n    use_rot: false", 1)
    text = text.replace("  val:\n", "  val_unused:\n", 1)
    path = tmp_path / ("deg.yml" if degrade else "plain.yml")
    path.write_text(text)
    return str(path)


def test_test_dataloader_undegraded_matches_jax(tmp_path, monkeypatch,
                                                capsys):
    hr = _image_folder(str(tmp_path / "hr"), n=4, hw=(32, 32),
                       grey_one=False)
    opt = _dl_options(tmp_path, hr, degrade=False)
    run_jax("test_dataloader", ["-opt", opt, "-n", "2", "-out",
                                str(tmp_path / "j")], monkeypatch)
    want = capsys.readouterr().out.splitlines()
    got = run_port("test_dataloader", ["-opt", opt, "-n", "2", "-out",
                                       str(tmp_path / "p"), "--device",
                                       "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert len(got) == 2 and {"LR", "HR"} <= set(got[0])
    described = [ln for ln in want if ln.startswith("batch")]
    assert sorted(described) == sorted(ln for ln in mine
                                       if ln.startswith("batch"))
    same_images(str(tmp_path / "j"), str(tmp_path / "p"))


def test_test_dataloader_degraded_is_the_producers(tmp_path, capsys,
                                                  monkeypatch):
    """With ``train_sr.yml``'s shuffled bsrgan: the tool's batches are
    the loader's (recorded as the tool reads them: the crops are
    unseeded) through ``make_otf_degradation`` with a generator of the
    same seed, and its dumps are those batches."""
    from trainner_tpu_torch.data.common import tensor2img
    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.scripts import test_dataloader as tool
    from trainner_tpu_torch.train.producer import make_otf_degradation

    read = []
    real = tool.create_dataloader

    def recording(*args, **kwargs):
        for batch in real(*args, **kwargs):
            read.append({k: v.clone() for k, v in batch.items()
                         if isinstance(v, torch.Tensor)})
            yield batch

    monkeypatch.setattr(tool, "create_dataloader", recording)
    hr = _image_folder(str(tmp_path / "hr"), n=4, hw=(100, 100),
                       grey_one=False)
    path = _dl_options(tmp_path, hr, degrade=True)
    got = run_port("test_dataloader", ["-opt", path, "-n", "2", "-out",
                                       str(tmp_path / "p"), "--device",
                                       "cpu"])
    out = capsys.readouterr().out
    assert len(got) == 2 and len(read) >= 2
    assert out.count("batch0.") == out.count("batch1.") == len(got[0])
    degrade = make_otf_degradation(
        parse(path, is_train=True), device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert degrade is not None
    for i in range(2):
        want = degrade(read[i])
        assert set(want) == set(got[i])
        for k, v in want.items():
            assert torch.equal(got[i][k], v), (i, k)
            for j in range(v.shape[0]):
                img = decode_image(str(tmp_path / "p" / f"batch{i}" /
                                       f"{k}_{j}.png"))
                assert np.array_equal(img, tensor2img(v[j].numpy())), (k, j)
    assert got[0]["LR"].shape[1] * 4 == got[0]["HR"].shape[1]
