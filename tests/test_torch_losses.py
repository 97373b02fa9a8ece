"""The port's losses (``trainner_tpu_torch/losses``) against the JAX
package's on the same arrays, f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.losses import gan as jax_gan
from trainner_tpu.losses.generator_loss import GeneratorLoss as JaxGenLoss
from trainner_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from trainner_tpu_torch.losses.basic import get_pixel_criterion
from trainner_tpu_torch.losses.gan import (AdversarialLoss,
                                           build_adversarial, gan_loss)
from trainner_tpu_torch.losses.generator_loss import (GeneratorLoss,
                                                      build_loss_list)
from trainner_tpu_torch.losses.perceptual import PerceptualLoss
from trainner_tpu_torch.utils.torch_interop import vgg_from_jax

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)

RNG = np.random.RandomState(0)
LOGITS = (RNG.randn(6, 1) * 2).astype(np.float32)


def _close(got, want, tol=1e-6):
    """Scalars in f32: relative 1e-6 (a mean summed in another order)."""
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "hinge"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("is_disc", [True, False])
def test_gan_loss_matches_jax(gan_type, real, is_disc):
    _close(gan_loss(gan_type, torch.from_numpy(LOGITS), real, is_disc),
           jax_gan.gan_loss(gan_type, jnp.asarray(LOGITS), real, is_disc))


def _toy_d():
    """A linear 'discriminator' with features, the same in both
    frameworks: logits = mean over pixels of x @ w."""
    w = RNG.randn(3, 1).astype(np.float32)

    def d_jax(x, want_maps=False):
        logits = jnp.mean(x @ jnp.asarray(w), axis=(1, 2))
        return (logits, [x * 2.0, x[:, ::2] + 1.0]) if want_maps else logits

    def d_torch(x, want_maps=False):
        logits = (x @ torch.from_numpy(w)).mean((1, 2))
        return (logits, [x * 2.0, x[:, ::2] + 1.0]) if want_maps else logits

    return d_jax, d_torch


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "hinge"])
@pytest.mark.parametrize("form", ["relativistic", "standard"])
@pytest.mark.parametrize("featmaps", [False, True])
def test_adversarial_losses_match_jax(gan_type, form, featmaps):
    """generator_loss (times gan_weight, plus the feature-matching term)
    and discriminator_loss with its four logs."""
    fake = RNG.rand(4, 8, 8, 3).astype(np.float32)
    real = RNG.rand(4, 8, 8, 3).astype(np.float32)
    d_jax, d_torch = _toy_d()
    kw = dict(gan_type=gan_type, gan_weight=5e-3, form=form,
              use_featmaps=featmaps, dis_feature_weight=0.3)
    want = jax_gan.AdversarialLoss(**kw)
    got = AdversarialLoss(**kw)
    tf, tr = torch.from_numpy(fake), torch.from_numpy(real)
    _close(got.generator_loss(d_torch, tf, tr),
           want.generator_loss(d_jax, jnp.asarray(fake), jnp.asarray(real)))
    l_d, logs = got.discriminator_loss(d_torch, tf, tr)
    w_d, w_logs = want.discriminator_loss(d_jax, jnp.asarray(fake),
                                          jnp.asarray(real))
    _close(l_d, w_d)
    assert set(logs) == set(w_logs)
    for k in logs:
        _close(logs[k], w_logs[k])


def test_generator_loss_gradient_skips_real_and_targets():
    """No gradient flows to the real batch in the G stage."""
    _, d_torch = _toy_d()
    fake = torch.rand(2, 4, 4, 3, requires_grad=True)
    real = torch.rand(2, 4, 4, 3, requires_grad=True)
    AdversarialLoss(use_featmaps=True).generator_loss(d_torch, fake, real
                                                      ).backward()
    assert fake.grad is not None and real.grad is None


def test_build_adversarial_defaults_to_relativistic_vanilla():
    adv = build_adversarial({"gan_weight": 5e-3})
    ref = jax_gan.build_adversarial({"gan_weight": 5e-3})
    assert (adv.gan_type, adv.form, adv.gan_weight, adv.use_featmaps) == \
        (ref.gan_type, ref.form, ref.gan_weight, ref.use_featmaps)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        build_adversarial({"gan_type": "wgan-gp"})


def _carry_vgg(jax_ploss, port_ploss):
    params = jax.tree.map(np.asarray,
                          jax.device_get(jax_ploss.variables["params"]))
    port_ploss.model.load_state_dict(vgg_from_jax(params), strict=False)


def test_perceptual_loss_matches_jax():
    """Two taps with weights, l1, on the JAX side's random VGG19 carried
    across: relative 1e-5."""
    layers = {"conv5_4": 1.0, "conv_2_2": 0.5}
    want = JaxPerceptual(layer_weights=dict(layers), dtype=jnp.float32)
    got = PerceptualLoss(layer_weights=dict(layers), dtype=torch.float32)
    _carry_vgg(want, got)
    sr = RNG.rand(2, 32, 32, 3).astype(np.float32)
    hr = RNG.rand(2, 32, 32, 3).astype(np.float32)
    t_sr = torch.from_numpy(sr).requires_grad_(True)
    t_hr = torch.from_numpy(hr).requires_grad_(True)
    loss = got(t_sr, t_hr)
    _close(loss, want(jnp.asarray(sr), jnp.asarray(hr)), 1e-5)
    loss.backward()
    assert t_sr.grad is not None and t_hr.grad is None
    assert all(not p.requires_grad for p in got.parameters())


def test_generator_loss_logs_and_total_match_jax():
    """pix (l1 x 1e-2) and fea (VGG19 conv5_4 l1 x 1.0): every log entry is
    the weighted value, the total their sum."""
    opt = {"train": {"pixel_criterion": "l1", "pixel_weight": 1e-2,
                     "feature_criterion": "l1", "feature_weight": 1.0}}
    want = JaxGenLoss(opt, device_dtype=jnp.float32)
    got = GeneratorLoss(opt, device_dtype=torch.float32)
    _carry_vgg(want.entries[1].fn, got.entries[1].fn)
    sr = RNG.rand(2, 32, 32, 3).astype(np.float32)
    hr = RNG.rand(2, 32, 32, 3).astype(np.float32)
    w_total, w_logs = want(jnp.asarray(sr), jnp.asarray(hr))
    total, logs = got(torch.from_numpy(sr), torch.from_numpy(hr))
    assert list(logs) == list(w_logs) == ["l_g_pix", "l_g_fea"]
    for k in logs:
        _close(logs[k], w_logs[k], 1e-5)
    _close(total, w_total, 1e-5)
    _close(total, float(logs["l_g_pix"]) + float(logs["l_g_fea"]))


@pytest.mark.parametrize("name", ["l1", "l2", "mse", "L1"])
def test_pixel_criteria_match_jax(name):
    from trainner_tpu.losses.basic import get_pixel_criterion as jax_crit

    a = RNG.rand(2, 5, 5, 3).astype(np.float32)
    b = RNG.rand(2, 5, 5, 3).astype(np.float32)
    _close(get_pixel_criterion(name)(torch.from_numpy(a),
                                     torch.from_numpy(b)),
           jax_crit(name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("train_opt", [
    {"pixel_criterion": "cb", "pixel_weight": 1.0},
    {"ssim_weight": 1.0, "ssim_type": "ssim"},
    {"tv_weight": 1.0, "tv_type": "normal"},
    {"cx_weight": 1.0, "cx_type": "contextual"},
    {"feature_criterion": "l1", "feature_weight": 1.0,
     "feature_network": "resnet101"},
])
def test_unported_losses_raise_and_name_their_item(train_opt):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 10.7"):
        build_loss_list(train_opt)
