"""The port's feature-network losses against the JAX package's, f32 on the
CPU: the contextual loss (three distances x three calc types, whole and
subsampled maps), the ResNet-101 and MINC feature losses, the gram-matrix
style loss, LPIPS as a training loss, and LPIPS as the validation metric
on each of its three backbones, with its refusal to run without weights.
The JAX side draws its networks' random weights from fixed keys and the
port draws its own, so each test carries the JAX weights across
(``utils/torch_interop.py``).

Tolerances: values 1e-5 relative, gradients with respect to the output
1e-4 of their largest element (the contextual loss divides each distance
by its row's minimum plus 1e-5, which amplifies rounding), unless a test
says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.losses import lpips as jax_lpips
from trainner_tpu.losses.contextual import ContextualLoss as JaxCX
from trainner_tpu.losses.perceptual import LPIPS as JaxLPIPS
from trainner_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from trainner_tpu.models import perceptual as jax_perceptual
from trainner_tpu.utils.metrics import MetricsDict as JaxMetrics
from trainner_tpu_torch.losses import lpips
from trainner_tpu_torch.losses.contextual import ContextualLoss
from trainner_tpu_torch.losses.perceptual import LPIPS, PerceptualLoss
from trainner_tpu_torch.models.perceptual import VGGFeatures, canonical_layer
from trainner_tpu_torch.utils.metrics import MetricsDict
from trainner_tpu_torch.utils.torch_interop import (lpips_from_jax,
                                                    resnet_from_jax,
                                                    vgg_from_jax)

torch.set_num_threads(2)

LPIPS_RELU = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _images(px=32, seed=0, b=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, px, px, 3).astype(np.float32)
    y = np.clip(0.7 * np.roll(x, 2, axis=1) + 0.3 * rng.rand(*x.shape),
                0, 1).astype(np.float32)
    return x, y


def _check(port_fn, jax_fn, x, y, rel=1e-5, grad_rel=1e-4):
    want, wgrad = jax.value_and_grad(jax_fn)(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    got = port_fn(tx, torch.from_numpy(y))
    assert abs(float(got.detach()) - float(want)) <= rel * abs(float(want)), \
        (float(got), float(want))
    got.backward()
    wgrad = np.asarray(wgrad)
    err = np.abs(tx.grad.numpy() - wgrad).max()
    assert np.isfinite(tx.grad.numpy()).all()
    assert err <= grad_rel * np.abs(wgrad).max(), err


@pytest.mark.parametrize("distance", ["cosine", "l2", "l1"])
@pytest.mark.parametrize("calc", ["regular", "symetric", "bilateral"])
@pytest.mark.parametrize("max_points", [4096, 20])
def test_contextual_matches_jax(distance, calc, max_points):
    """VGG19 conv3_2 and conv4_2 (8 x 8 and 4 x 4 maps at 32 px); with
    ``max_points`` 20 every map is subsampled (stride 4 and 1: the second
    map's 16 positions stay) and the bilateral reduction takes its
    second branch."""
    kw = dict(distance_type=distance, calc_type=calc, max_points=max_points)
    want = JaxCX(dtype=jnp.float32, **kw)
    got = ContextualLoss(dtype=torch.float32, **kw)
    got.model.load_state_dict(vgg_from_jax(_numpy(want.variables)),
                              strict=False)
    x, y = _images(seed=1)
    _check(got, want, x, y)


def test_contextual_on_pixels_matches_jax():
    """``use_vgg`` off: the loss on the images themselves, 12 x 12 px. The
    3-channel cosines lie close together, so d / (d_min + 1e-5) amplifies
    rounding further than on features: the value within 1e-5, and the
    gradient of each package in f32 within 2e-4 of its largest element
    from an f64 run of the port's code (each side reads 5e-5 to 7e-5), so
    the two within 4e-4 of each other."""
    want = JaxCX(use_vgg=False, dtype=jnp.float32)
    got = ContextualLoss(use_vgg=False, dtype=torch.float32)
    x, y = _images(12, seed=2)
    _check(got, want, x, y, grad_rel=4e-4)
    wgrad = np.asarray(jax.grad(want)(jnp.asarray(x), jnp.asarray(y)))
    grads = {}
    for dt in (torch.float32, torch.float64):
        t = torch.from_numpy(x).to(dt).requires_grad_(True)
        got._cx(t.reshape(2, 144, 3),
                torch.from_numpy(y).to(dt).reshape(2, 144, 3),
                (12, 12)).backward()
        grads[dt] = t.grad.double().numpy()
    ref = grads[torch.float64]
    for side in (grads[torch.float32], wgrad):
        assert np.abs(side - ref).max() <= 2e-4 * np.abs(ref).max()


@pytest.mark.parametrize("arch", ["resnet101", "minc"])
def test_single_tap_feature_losses_match_jax(arch):
    """ResNet-101 (its batch norms on their running statistics, carried
    with them) and MINC, one tap 'feat', l1, at 32 px."""
    want = JaxPerceptual(arch=arch, dtype=jnp.float32)
    got = PerceptualLoss(arch=arch, dtype=torch.float32)
    assert got.layer_weights == want.layer_weights == {"feat": 1.0}
    variables = _numpy(want.variables)
    sd = resnet_from_jax(variables) if arch == "resnet101" \
        else vgg_from_jax(variables)
    missing, unexpected = got.model.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {"mean", "std"}
    x, y = _images(seed=3)
    _check(got, want, x, y)


def test_minc_names_and_last_conv():
    """MINC's first two blocks are named conv11 .. conv22, the rest
    conv3_1 .. conv5_3, as flax names them; its last conv has no ReLU (the
    map has negative values)."""
    want = JaxPerceptual(arch="minc", dtype=jnp.float32)
    got = PerceptualLoss(arch="minc", dtype=torch.float32)
    assert sorted(_numpy(want.variables)["params"]) == sorted(
        got.model.names)
    got.model.load_state_dict(vgg_from_jax(_numpy(want.variables)))
    out = got.features(torch.from_numpy(_images(seed=4)[0]))["feat"]
    assert out.shape == (2, 2, 2, 512) and (out < 0).any()


@pytest.mark.parametrize("layers", [{"conv3_2": 1.0},
                                    {"conv_2_2": 0.5, "conv5_4": 1.0}])
def test_style_loss_matches_jax(layers):
    """The gram-matrix form over VGG19 taps (l1 on the (b, c, c) grams)."""
    want = JaxPerceptual(layer_weights=layers, style=True, dtype=jnp.float32)
    got = PerceptualLoss(layer_weights=layers, style=True,
                         dtype=torch.float32)
    got.model.load_state_dict(vgg_from_jax(_numpy(want.variables)),
                              strict=False)
    x, y = _images(seed=5)
    _check(got, want, x, y)


def _vgg_npz(path, blocks=(2, 2, 4, 4, 4), seed=4):
    rng = np.random.RandomState(seed)
    arrays, cin = {}, 3
    for b, n in enumerate(blocks, start=1):
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


@pytest.mark.parametrize("weights", ["random", "vgg16", "vgg19"])
def test_lpips_loss_matches_jax(weights, tmp_path):
    """LPIPS as a loss: VGG16 ReLU taps, unit normalisation, the bundled
    vgg lin vectors. Its weights carried from the JAX side's random VGG16,
    or read by both from a VGG16 file or from a VGG19 file, which both
    packages read into the VGG16 by name (conv3_4, conv4_4 and conv5_4
    unused). The JAX side's taps are spelled so that its VGGFeatures finds
    them: as built, its LPIPS loss raises KeyError (ROADMAP C 18)."""
    path = None
    if weights != "random":
        path = _vgg_npz(tmp_path / f"{weights}.npz",
                        (2, 2, 3, 3, 3) if weights == "vgg16"
                        else (2, 2, 4, 4, 4))
    want = JaxLPIPS(weights_path=path)
    with pytest.raises(KeyError, match="relu:conv1_2"):
        want(jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 3)))
    want.model = jax_perceptual.VGGFeatures(arch="vgg16", listen=LPIPS_RELU,
                                            use_input_norm=True)
    got = LPIPS(weights_path=path)
    if path is None:
        got.model.load_state_dict(vgg_from_jax(_numpy(want.variables)),
                                  strict=False)
    assert got.n_lin == 5
    x, y = _images(seed=6)
    _check(got, want, x, y)


def test_canonical_layer_keeps_a_relu_tap():
    """The port's canonical_layer leaves a name in its own form as it is,
    where the JAX package's turns 'relu:conv4_1' into a name no
    VGGFeatures tap has; so the port's VGGFeatures finds a ReLU tap given
    in either spelling, and its values are the JAX ones."""
    assert canonical_layer("relu:conv4_1") == canonical_layer("relu4_1") \
        == "relu:conv4_1"
    assert jax_perceptual.canonical_layer("relu:conv4_1") != "relu:conv4_1"
    mod = jax_perceptual.VGGFeatures(arch="vgg19", listen=("relu4_1",))
    variables = _numpy(mod.init(jax.random.PRNGKey(2),
                                jnp.zeros((1, 32, 32, 3))))
    x = _images(seed=7)[0]
    want = np.asarray(mod.apply(variables, jnp.asarray(x))["relu:conv4_1"])
    for listen in (("relu4_1",), ("relu:conv4_1",)):
        net = VGGFeatures(arch="vgg19", listen=listen)
        net.load_state_dict(vgg_from_jax(variables), strict=False)
        got = net(torch.from_numpy(x))["relu:conv4_1"].detach().numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _metric_images(seed):
    rng = np.random.RandomState(seed)
    a = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-40, 40, a.shape),
                0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("net", ["squeeze", "alex", "vgg"])
def test_lpips_metric_matches_jax(net):
    """The metric on uint8 and float images, random backbones
    (``allow_random``) carried across from the JAX side's, bundled lin
    vectors in neither (flax's init: ones)."""
    want = jax_lpips.LPIPSMetric(net=net, allow_random=True)
    a, b = _metric_images(8)
    w_u8 = want(a, b)
    got = lpips.LPIPSMetric(net=net, allow_random=True, device="cpu")
    missing, unexpected = got.model.load_state_dict(
        lpips_from_jax(_numpy(want._params)), strict=False)
    assert not unexpected and set(missing) == {"shift", "scale"}
    g_u8 = got(a, b)
    assert abs(g_u8 - w_u8) <= 1e-5 * abs(w_u8)
    af, bf = a / 255.0, b / 255.0
    assert abs(got(af, bf) - float(want(af, bf))) <= 1e-5 * abs(w_u8)


def _lpips_file(path, net, with_lin):
    """A converted LPIPS file written from the JAX side's random init
    ('net/<conv>/kernel|bias', and 'lin{i}' when ``with_lin``)."""
    want = jax_lpips.LPIPSMetric(net=net, allow_random=True)
    want(*_metric_images(9))
    params = _numpy(want._params)["params"]
    arrays = {f"net/{layer}/{leaf}": v
              for layer, node in params["net"].items()
              for leaf, v in node.items()}
    if with_lin:
        rng = np.random.RandomState(10)
        arrays.update({k: rng.rand(*v.shape).astype(np.float32)
                       for k, v in params.items() if k.startswith("lin")})
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("with_lin", [True, False])
def test_lpips_metric_from_a_file_matches_jax(with_lin, tmp_path):
    """Weights from a converted file; without lin vectors in it both take
    the bundled calibrated squeeze set."""
    path = _lpips_file(tmp_path / "lpips_squeeze.npz", "squeeze", with_lin)
    want = jax_lpips.LPIPSMetric(net="squeeze", weights_path=path)
    got = lpips.LPIPSMetric(net="squeeze", weights_path=path, device="cpu")
    if not with_lin:
        bundled = np.load(lpips.bundled_lin_path("squeeze"))
        np.testing.assert_array_equal(got.model.lin3.numpy(),
                                      bundled["lin3"])
    a, b = _metric_images(11)
    w = want(a, b)
    assert abs(got(a, b) - w) <= 1e-5 * abs(w)


def test_lpips_refuses_to_run_without_weights(monkeypatch, tmp_path):
    """Neither package runs LPIPS without backbone weights: the metric and
    MetricsDict with 'lpips' raise LPIPSWeightsMissing at setup, the
    message naming the converter and the three ways to give the file;
    ``$TRAINNER_LPIPS_WEIGHTS`` is read when it names a file."""
    monkeypatch.delenv("TRAINNER_LPIPS_WEIGHTS", raising=False)
    for pkg in (jax_lpips, lpips):
        assert pkg.find_lpips_weights("squeeze") is None
    with pytest.raises(lpips.LPIPSWeightsMissing,
                       match="convert_torch_model.py lpips-full"):
        lpips.LPIPSMetric(net="squeeze", device="cpu")
    with pytest.raises(jax_lpips.LPIPSWeightsMissing):
        jax_lpips.LPIPSMetric(net="squeeze")
    with pytest.raises(lpips.LPIPSWeightsMissing,
                       match="TRAINNER_LPIPS_WEIGHTS"):
        MetricsDict("psnr,lpips", device="cpu")
    assert lpips._missing_msg("alex") == jax_lpips._missing_msg("alex")
    path = _lpips_file(tmp_path / "env.npz", "squeeze", True)
    monkeypatch.setenv("TRAINNER_LPIPS_WEIGHTS", path)
    assert lpips.find_lpips_weights("squeeze") == path \
        == jax_lpips.find_lpips_weights("squeeze")
    lpips.LPIPSMetric(net="squeeze", device="cpu")


def test_metrics_dict_with_lpips_matches_jax(tmp_path):
    """MetricsDict('psnr,ssim,lpips', lpips_weights=file): each entry and
    each average as the JAX package's, LPIPS within 1e-5."""
    path = _lpips_file(tmp_path / "lpips_squeeze.npz", "squeeze", True)
    want = JaxMetrics("psnr,ssim,lpips", lpips_weights=path)
    got = MetricsDict("psnr,ssim,lpips", lpips_weights=path, device="cpu")
    for seed in (12, 13):
        a, b = _metric_images(seed)
        w, g = want.calculate_metrics(a, b, crop_size=4), \
            got.calculate_metrics(a, b, crop_size=4)
        assert set(g) == set(w) == {"psnr", "ssim", "lpips"}
        assert abs(g["lpips"] - w["lpips"]) <= 1e-5 * abs(w["lpips"])
        assert abs(g["psnr"] - w["psnr"]) <= 1e-9 * w["psnr"]
    assert [a["name"] for a in got.get_averages()] == ["psnr", "ssim",
                                                       "lpips"]
