"""The port's pixel criteria, SSIM and MS-SSIM, regularisers, FDPL and
``build_loss_list`` / ``GeneratorLoss`` (``trainner_tpu_torch/losses``)
against the JAX package's on the same arrays, f32 on the CPU, values and
gradients with respect to the output image.

Tolerances: values 1e-5 relative (f32 sums in another order); gradients
1e-5 of the gradient's largest element, MS-SSIM's 1e-4 (its gradient is a
product of five powers of per-level terms, each with its own rounding).
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.losses import basic as jax_basic
from trainner_tpu.losses import generator_loss as jax_gl
from trainner_tpu.losses import regularizers as jax_reg
from trainner_tpu.losses.lpips import LPIPSWeightsMissing as JaxMissing
from trainner_tpu.models.perceptual import VGGFeatures as JaxVGG
from trainner_tpu.ops.filters import filter_low as jax_filter_low
from trainner_tpu_torch.losses import basic, generator_loss as gl
from trainner_tpu_torch.losses import regularizers as reg
from trainner_tpu_torch.losses import ssim as port_ssim
from trainner_tpu_torch.losses.lpips import LPIPSWeightsMissing
from trainner_tpu_torch.ops.filters import filter_low
from trainner_tpu_torch.options.config import read_yaml
from trainner_tpu_torch.utils.torch_interop import vgg_from_jax

# the module, not the function that trainner_tpu.losses exports by name
jax_ssim = importlib.import_module("trainner_tpu.losses.ssim")

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LPIPS_RELU = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")


def _images(px=40, seed=0, b=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, px, px, 3).astype(np.float32)
    # the target a smoothed, shifted copy: structure in common, as SR has
    y = np.clip(0.7 * np.roll(x, 1, axis=2) + 0.3 * rng.rand(*x.shape),
                0, 1).astype(np.float32)
    return x, y


def _check(port_fn, jax_fn, arrays, rel=1e-5, floor=0.0, grad_rel=1e-5):
    """port_fn(*tensors) against jax_fn(*arrays): the value within ``rel``
    of max(|value|, floor), the gradient with respect to the first
    argument within ``grad_rel`` of its largest element."""
    want, wgrad = jax.value_and_grad(
        lambda a, *rest: jax_fn(a, *rest))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    ts[0].requires_grad_(True)
    got = port_fn(*ts)
    assert abs(float(got.detach()) - float(want)) <= \
        rel * max(abs(float(want)), floor), (float(got), float(want))
    got.backward()
    wgrad = np.asarray(wgrad)
    err = np.abs(ts[0].grad.numpy() - wgrad).max()
    assert np.isfinite(ts[0].grad.numpy()).all()
    assert err <= grad_rel * np.abs(wgrad).max() + 1e-12, err


@pytest.mark.parametrize("name", sorted(jax_basic.PIXEL_CRITERIA) + [
    "multiscale", "multiscale-l1", "multiscale_cb", "MultiScale-L2",
    "Relative-L1", "L1_Cosine_Sim"])
def test_pixel_criteria_match_jax(name):
    x, y = _images(32)
    _check(basic.get_pixel_criterion(name),
           jax_basic.get_pixel_criterion(name), (x, y))


def test_masked_l1_and_an_unknown_criterion():
    x, y = _images(16)
    mask = (np.random.RandomState(2).rand(2, 16, 16, 1) > 0.5).astype(
        np.float32)
    _check(basic.masked_l1, jax_basic.masked_l1, (x, y, mask))
    with pytest.raises(NotImplementedError, match="not found"):
        basic.get_pixel_criterion("l3")


@pytest.mark.parametrize("px", [40, 23])
@pytest.mark.parametrize("kind,kw", [
    ("ssim", {}), ("ssim", {"use_padding": True}), ("ssim", {"shave": 4}),
    ("ssim", {"window_size": 7, "sigma": 1.0}),
    ("ms_ssim", {}), ("ms_ssim", {"levels": 3}),
    ("ms_ssim", {"use_padding": True})])
def test_ssim_and_ms_ssim_match_jax(px, kind, kw):
    """40 px and 23 px: odd sizes (MS-SSIM's zero-padded downsampling) and
    maps smaller than the window (its shrinking window: 23 -> 12 -> 6 -> 3
    -> 2 px, the window 11, 11, 5, 3, 1). SSIM of these pairs is about
    0.1-0.5, so a value is held to 1e-5 of 1 (``1 - ssim``, the loss)."""
    x, y = _images(px, seed=px)
    name = kind + "_loss"
    _check(lambda a, b: getattr(port_ssim, name)(a, b, **kw),
           lambda a, b: getattr(jax_ssim, name)(a, b, **kw), (x, y),
           grad_rel=1e-4 if kind == "ms_ssim" else 1e-5)


def test_ms_ssim_gradient_through_the_clamp():
    """An inverted target makes the first levels' contrast-structure terms
    negative: they sit at the 1e-6 clamp, which must come before the power
    (x ** w has an infinite derivative at 0). Value and gradient as JAX's,
    all finite."""
    x, _ = _images(40, seed=3)
    _check(port_ssim.ms_ssim_loss, jax_ssim.ms_ssim_loss, (x, 1.0 - x),
           grad_rel=1e-4)


def _sized(fn, **kw):
    return lambda *a: fn(*a, **kw)


REGULARIZERS = {
    "hfen": (reg.hfen, jax_reg.hfen, {}),
    "hfen-norm": (reg.hfen, jax_reg.hfen, {"norm": True}),
    "hfen-l2": (reg.hfen, jax_reg.hfen,
                {"criterion": "l2"}),
    "grad-2d": (reg.gradient_loss, jax_reg.gradient_loss, {}),
    "grad-4d-l2": (reg.gradient_loss, jax_reg.gradient_loss,
                   {"four_d": True, "criterion": "l2"}),
    "gp": (reg.gp_loss, jax_reg.gp_loss, {}),
    "gp-trace": (reg.gp_loss, jax_reg.gp_loss, {"trace": True}),
    "cp": (reg.cp_loss, jax_reg.cp_loss, {}),
    "cp-denorm": (reg.cp_loss, jax_reg.cp_loss,
                  {"spl_denorm": True, "yuvgrad": False}),
    "spl": (reg.spl_loss, jax_reg.spl_loss, {}),
    "spl-trace": (reg.spl_loss, jax_reg.spl_loss, {"trace": True}),
    "fft": (reg.fft_loss, jax_reg.fft_loss, {}),
    "color": (reg.color_loss, jax_reg.color_loss, {}),
    "color-cb": (reg.color_loss, jax_reg.color_loss,
                 {"criterion": "cb", "ds_f": 2}),
    "avg": (reg.average_loss, jax_reg.average_loss, {}),
    "fdpl": (gl.fdpl_loss, jax_gl.fdpl_loss, {}),
}


@pytest.mark.parametrize("name", sorted(REGULARIZERS))
def test_regularizers_match_jax(name):
    """The two-image regularisers at 36 px (FDPL cuts to 32). The profile
    losses are sums of cosines near -1 per row, so their values are held
    to 1e-5 of their own size too."""
    port_fn, jax_fn, kw = REGULARIZERS[name]
    kw_p, kw_j = dict(kw), dict(kw)
    if "criterion" in kw:
        kw_p["criterion"] = basic.get_pixel_criterion(kw["criterion"])
        kw_j["criterion"] = jax_basic.get_pixel_criterion(kw["criterion"])
    x, y = _images(36, seed=5)
    _check(_sized(port_fn, **kw_p), _sized(jax_fn, **kw_j), (x, y))


@pytest.mark.parametrize("tv_type", ["tv", "dtv", "4d"])
@pytest.mark.parametrize("p", [1, 2])
def test_tv_matches_jax(tv_type, p):
    x, _ = _images(24, seed=6)
    _check(lambda a: reg.tv_loss(a, tv_type, p),
           lambda a: jax_reg.tv_loss(a, tv_type, p), (x,))


@pytest.mark.parametrize("name", ["overflow", "range"])
def test_range_losses_match_jax(name):
    """On an image that leaves [0, 1] on both sides."""
    x = (np.random.RandomState(7).rand(2, 16, 16, 3) * 1.6 - 0.3).astype(
        np.float32)
    fn = f"{name}_loss"
    _check(getattr(reg, fn), getattr(jax_reg, fn), (x,))


def test_fdpl_weights_match_jax(tmp_path):
    w = np.random.RandomState(8).rand(8, 8).astype(np.float32)
    x, y = _images(24, seed=9)
    _check(lambda a, b: gl.fdpl_loss(a, b, weights=w),
           lambda a, b: jax_gl.fdpl_loss(a, b, weights=jnp.asarray(w)),
           (x, y))
    np.testing.assert_allclose(gl._dct_matrix(8), jax_gl._dct_matrix(8))


def _vgg19_npz(path, seed=4):
    """A converted-VGG19 file drawn from a numpy seed (He-scaled kernels,
    small biases)."""
    rng = np.random.RandomState(seed)
    arrays, cin = {}, 3
    for b, n in enumerate((2, 2, 4, 4, 4), start=1):
        cout = 64 * min(2 ** (b - 1), 8)
        for c in range(1, n + 1):
            arrays[f"conv{b}_{c}/kernel"] = (
                rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))
            ).astype(np.float32)
            arrays[f"conv{b}_{c}/bias"] = (rng.randn(cout) * 0.01).astype(
                np.float32)
            cin = cout
    np.savez(path, **arrays)
    return str(path)


def _pair(train_opt, vgg_path=None, **kw):
    """The JAX and port ``GeneratorLoss`` on one options dict, f32, the
    JAX side's random feature nets carried across, its LPIPS loss's taps
    spelled so that it runs (ROADMAP C 18)."""
    opt = {"train": dict(train_opt), "path": {"vgg_weights": vgg_path}}
    want = jax_gl.GeneratorLoss(opt, device_dtype=jnp.float32, **kw)
    got = gl.GeneratorLoss(opt, device_dtype=torch.float32, **kw)
    for g, w in zip(got.entries, want.entries):
        if w.name == "l_g_lpips":
            w.fn.model = JaxVGG(arch="vgg16", listen=LPIPS_RELU,
                                use_input_norm=True)
        elif hasattr(w.fn, "variables") and not vgg_path:
            g.fn.model.load_state_dict(vgg_from_jax(jax.tree.map(
                np.asarray, w.fn.variables)), strict=False)
    return want, got


def _same_entries(got, want):
    assert [(e.name, e.tag, e.weight, e.needs_target, e.precise)
            for e in got.entries] == \
        [(e.name, e.tag, e.weight, e.needs_target, e.precise)
         for e in want.entries]


def _same_logs(got, want, sr, hr, rel=1e-5, **call):
    w_total, w_logs = want(jnp.asarray(sr), jnp.asarray(hr), **{
        k: v[0] for k, v in call.items()})
    total, logs = got(torch.from_numpy(sr), torch.from_numpy(hr), **{
        k: v[1] for k, v in call.items()})
    assert list(logs) == list(w_logs)
    for k in logs:
        assert abs(float(logs[k]) - float(w_logs[k])) <= \
            rel * abs(float(w_logs[k])), k
    assert abs(float(total) - float(w_total)) <= rel * abs(float(w_total))
    return logs


OPTION_KEYS = {
    "pixel": {"pixel_weight": 0.5, "pixel_criterion": "elastic"},
    "feature": {"feature_weight": 1.0, "feature_criterion": "l1",
                "feature_layers": {"conv3_2": 1.0, "conv4_4": 0.5}},
    "cx": {"cx_weight": 0.5, "cx_type": "contextual"},
    "cx-layers": {"cx_weight": 1.0, "cx_type": "contextual",
                  "cx_vgg_layers": {"conv_2_2": 1.0}},
    "lpips": {"lpips_weight": 0.5},
    "hfen": {"hfen_weight": 1e-2, "hfen_criterion": "cb"},
    "grad": {"grad_weight": 1.0, "grad_type": "grad-4d-l2"},
    "grad-bare": {"grad_weight": 1.0, "grad_type": "grad-2d"},
    "tv": {"tv_weight": 1e-2, "tv_type": "normal"},
    "dtv": {"tv_weight": 1e-2, "tv_type": "4D", "tv_norm": 2},
    "ssim": {"ssim_weight": 1.0, "ssim_type": "ssim"},
    "ms-ssim": {"ssim_weight": 0.2, "ssim_type": "ms-ssim"},
    "spl": {"spl_weight": 0.1, "spl_type": "spl"},
    "gpl": {"spl_weight": 0.1, "spl_type": "gpl"},
    "cpl": {"spl_weight": 0.1, "spl_type": "cpl"},
    "of": {"of_weight": 1.0, "of_type": "of"},
    "range": {"range_weight": 1.0},
    "fft": {"fft_weight": 0.1, "fft_type": "fft"},
    "color": {"color_weight": 1.0, "color_criterion": "color-l1"},
    "avg": {"avg_weight": 1.0, "avg_criterion": "avg-l2"},
    "ms": {"ms_weight": 1.0, "ms_criterion": "multiscale-l1"},
    "fdpl": {"fdpl_weight": 1.0, "fdpl_type": "fdpl"},
    "weight-only": {"hfen_weight": 1.0, "cx_weight": 1.0,
                    "ssim_weight": 1.0, "fft_weight": 1.0},
}


@pytest.mark.parametrize("key", sorted(OPTION_KEYS))
def test_build_loss_list_on_each_option_key(key, tmp_path):
    """Each option key alone: the entries (names, tags, weights, target
    and precise flags) as JAX's, the logs and total within 1e-5 on an
    image pair with an output outside [0, 1]. A weight without its
    type or criterion makes no entry in either package."""
    vgg = _vgg19_npz(tmp_path / "vgg19.npz") if key == "lpips" else None
    want, got = _pair(OPTION_KEYS[key], vgg)
    _same_entries(got, want)
    assert bool(got.entries) == (key != "weight-only")
    x, y = _images(32, seed=10)
    _same_logs(got, want, x * 1.2 - 0.1, y)


def _yml_train_block(uncomment: bool) -> list:
    """``train_sr.yml``'s train section, its loss block (lines 82-88:
    cx_weight .. lpips_weight) uncommented as a user would."""
    lines = (ROOT / "options" / "sr" / "train_sr.yml").read_text().split(
        "\n")
    keys = ("cx_weight", "hfen_weight", "tv_type", "tv_weight", "ssim_type",
            "ssim_weight", "lpips_weight")
    if uncomment:
        lines = [ln.replace("# ", "", 1) if ln.strip().lstrip("# ").split(
            ":")[0] in keys else ln for ln in lines]
    return lines


def test_train_sr_yml_loss_block_uncommented_literally(tmp_path):
    """Uncommented as shipped, the block sets cx_weight without cx_type and
    hfen_weight without hfen_criterion: both make no entry, in both
    packages; lpips_weight without path.vgg_weights raises
    LPIPSWeightsMissing in both; with a VGG file the stack is pix, fea,
    lpips, tv, ms-ssim, and its logs agree within 1e-4: at 32 px MS-SSIM's
    last level is 2 px under a window of 1, where each variance is a
    difference of equal products whose rounding is divided by c2 = 9e-4."""
    yml = tmp_path / "train_sr.yml"
    yml.write_text("\n".join(_yml_train_block(True)))
    train = read_yaml(str(yml))["train"]
    for k in ("cx_weight", "hfen_weight", "lpips_weight", "ssim_type"):
        assert k in train
    with pytest.raises(LPIPSWeightsMissing):
        gl.build_loss_list(train)
    with pytest.raises(JaxMissing):
        jax_gl.build_loss_list(train)
    want, got = _pair(train, _vgg19_npz(tmp_path / "vgg19.npz"))
    _same_entries(got, want)
    assert [e.name for e in got.entries] == [
        "l_g_pix", "l_g_fea", "l_g_lpips", "l_g_tv", "l_g_ssim"]
    x, y = _images(32, seed=11)
    _same_logs(got, want, x, y, rel=1e-4)


STACK = {"pixel_weight": 1.0, "pixel_criterion": "l1",
         "ms_weight": 1.0, "ms_criterion": "multiscale-l1",
         "avg_weight": 1.0, "avg_criterion": "avg-l1",
         "color_weight": 1.0, "color_criterion": "color-l1",
         "tv_weight": 1.0, "tv_type": "tv",
         "ssim_weight": 1.0, "ssim_type": "ssim",
         "fft_weight": 0.1, "fft_type": "fft",
         "hfen_weight": 1.0, "hfen_criterion": "l1"}


@pytest.mark.parametrize("selectors", [
    None, ["pix"], ["pixel", "tv"], ["ssim", "ms-ssim"], ["multiscale"],
    ["fea"], ["color", "avg", "unknown"], ["HFEN", "fft"]])
def test_selectors_filter_as_jax(selectors):
    want, got = _pair(STACK)
    assert [e.name for e in gl.filter_selectors(got.entries, selectors)] \
        == [e.name for e in jax_gl.filter_selectors(want.entries,
                                                    selectors)]
    x, y = _images(32, seed=12)
    _same_logs(got, want, x, y, selectors=(selectors, selectors))


@pytest.mark.parametrize("filter_type", ["average", "gaussian"])
def test_f_low_routing_matches_jax(filter_type):
    """With ``f_low`` the pix, ms, avg, color and tv entries see the
    low-pass images, the others (ssim, fft, hfen) the originals: each log
    as JAX's, and the routed entries differ from their unrouted values."""
    want, got = _pair(STACK)
    x, y = _images(32, seed=13)
    logs = _same_logs(got, want, x, y, f_low=(
        lambda a: jax_filter_low(a, 9, filter_type=filter_type),
        lambda a: filter_low(a, 9, filter_type=filter_type)))
    _, plain = got(torch.from_numpy(x), torch.from_numpy(y))
    for e in got.entries:
        moved = float(logs[e.name]) != float(plain[e.name])
        assert moved == (e.tag in gl.FS_TAGS), e.name


def test_featnets_off_leaves_the_feature_losses_out():
    opt = dict(OPTION_KEYS["feature"], **OPTION_KEYS["cx"],
               lpips_weight=1.0, **OPTION_KEYS["tv"])
    names = [e.name for e in gl.build_loss_list(opt, allow_featnets=False)]
    assert names == [e.name for e in jax_gl.build_loss_list(
        opt, allow_featnets=False)] == ["l_g_tv"]


def _squeeze_npz(path, seed=5):
    """An LPIPS squeeze file with its backbone only (the bundled lin
    vectors complete it), drawn from a numpy seed."""
    from trainner_tpu_torch.losses.lpips import SqueezeFeatures

    rng = np.random.RandomState(seed)
    arrays = {}
    for name, m in SqueezeFeatures().named_children():
        k, cin, cout = m.kernel_size[0], m.in_channels, m.out_channels
        arrays[f"net/{name}/kernel"] = (rng.randn(k, k, cin, cout) * np.sqrt(
            2.0 / (k * k * cin))).astype(np.float32)
        arrays[f"net/{name}/bias"] = (rng.randn(cout) * 0.01).astype(
            np.float32)
    np.savez(path, **arrays)
    return str(path)


def test_the_cli_trains_the_stack_and_validates_with_lpips(tmp_path,
                                                            monkeypatch):
    """``options/sr/train_sr_debug.yml`` with the loss stack of
    ``train_sr.yml`` switched on (contextual, HFEN, tv, MS-SSIM, LPIPS on a
    seeded VGG19 file), wgan-gp with its penalty on a spectral-norm D and
    validation with psnr,ssim,lpips on a seeded squeeze file, through the
    training CLI on the CPU for 8 iterations: every loss logged at every
    step, finite, and LPIPS in the validation at 8."""
    from trainner_tpu_torch.train import cli, main
    from trainner_tpu_torch.train.sr_trainer import SRTrainer

    text = (ROOT / "options" / "sr" / "train_sr_debug.yml").read_text()
    edits = [
        ("root: /tmp/trainner_tpu_debug",
         f"root: {tmp_path / 'run'}\n"
         f"  vgg_weights: {_vgg19_npz(tmp_path / 'vgg19.npz')}\n"
         f"  lpips_weights: {_squeeze_npz(tmp_path / 'squeeze.npz')}"),
        ("  base_nf: 16", "  base_nf: 16\n  spectral_norm: true"),
        ("  niter: 12", "  niter: 8"),
        ("  gan_type: vanilla",
         "  gan_type: wgan-gp\n  gp_weight: 10\n  feature_criterion: l1\n"
         "  feature_weight: 1.0\n  cx_weight: 0.5\n  cx_type: contextual\n"
         "  hfen_weight: 1e-6\n  hfen_criterion: l1\n  tv_type: tv\n"
         "  tv_weight: 1e-5\n  ssim_type: ms-ssim\n  ssim_weight: 0.2\n"
         "  lpips_weight: 0.5"),
        ("metrics: psnr,ssim", "metrics: psnr,ssim,lpips")]
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "stack.yml"
    path.write_text(text)
    logs, vals = [], []
    step, validate = SRTrainer.train_step, cli.validate

    def train_step(self, state, batch):
        state, out = step(self, state, batch)
        logs.append({k: float(v) for k, v in out.items()})
        return state, out

    def validate_(*args, **kw):
        vals.append(validate(*args, **kw))
        return vals[-1]

    monkeypatch.setattr(SRTrainer, "train_step", train_step)
    monkeypatch.setattr(cli, "validate", validate_)
    state = main(["-opt", str(path)], device="cpu")
    assert state.step == 8 and len(logs) == 8
    want = {"l_g_pix", "l_g_fea", "l_g_cx", "l_g_lpips", "l_g_HFEN",
            "l_g_tv", "l_g_ssim", "l_g_gan", "l_d_gp", "l_d_total"}
    for lg in logs:
        assert want <= set(lg) and all(np.isfinite(v) for v in lg.values())
    assert len(vals) == 1 and set(vals[0]) == {"psnr", "ssim", "lpips"}
    assert np.isfinite(vals[0]["lpips"]) and vals[0]["lpips"] >= 0
