"""wgan-gp and the rest of the adversarial objectives of the port
(``trainner_tpu_torch/losses/gan.py``) against the JAX package's on the
CPU, f32: ``gan_loss`` for the wgan types; the multiscale and conditional
forms on a small analytic critic; the gradient penalty's value and the
D gradients it gives, fed JAX's alpha, with the spectral-norm U-Net and
D-VGG; three ``SRTrainer`` steps with the whole loss stack of
``train_sr.yml`` switched on (wgan-gp included) against the JAX trainer's;
and the refusal of wgan-gp with a batch-norm D (ROADMAP C 18).

Tolerances: 1e-5 relative for f32 losses of one call (their sums run in
another order), 1e-4 for D's gradients through a double backward of about
ten convs, and 1e-4 for the three steps' logs, as
``test_torch_train_step.py``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.losses.gan import (AdversarialLoss as JaxAdversarial,
                                     gan_loss as jax_gan_loss)
from trainner_tpu.models.discriminators import (DiscriminatorVGG as JaxVGG,
                                                UNetDiscriminator as JaxUNet)
from trainner_tpu.models.perceptual import VGGFeatures as JaxVGGFeatures
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu_torch.losses.gan import AdversarialLoss, gan_loss
from trainner_tpu_torch.models.discriminators import (DiscriminatorVGG,
                                                      UNetDiscriminator)
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import (discriminator_from_jax,
                                                    load_train_state,
                                                    train_state_from_jax)

torch.set_num_threads(2)

# the ReLU taps of the LPIPS loss, spelled so that the JAX package's
# VGGFeatures finds them (its LPIPS loss as built cannot: ROADMAP C 18)
LPIPS_RELU = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(got, want, rel=1e-5, floor=1e-6):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert np.isfinite(got)
    assert abs(got - want) <= rel * max(abs(want), floor), (got, want)


@pytest.mark.parametrize("gan_type", ["wgan-gp", "wgangp", "wgan"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("is_disc", [True, False])
def test_wgan_objectives_match_jax(gan_type, real, is_disc):
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    _close(gan_loss(gan_type, torch.from_numpy(x), real, is_disc),
           jax_gan_loss(gan_type, jnp.asarray(x), real, is_disc))


def _critics(c: int):
    """A two-scale analytic critic in both frameworks: tanh of a channel
    projection, averaged over the image, and its square."""
    w = np.random.RandomState(5).randn(c, 2).astype(np.float32)

    def jax_d(x, want_maps=False):
        h = jnp.tanh(x @ jnp.asarray(w)).mean((1, 2))
        out = [h[:, :1], h[:, 1:] ** 2]
        return (out, [h]) if want_maps else out

    def torch_d(x, want_maps=False):
        h = torch.tanh(x @ torch.from_numpy(w)).mean((1, 2))
        out = [h[:, :1], h[:, 1:] ** 2]
        return (out, [h]) if want_maps else out

    return jax_d, torch_d


@pytest.mark.parametrize("form", ["relativistic", "standard"])
@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("gan_type", ["vanilla", "wgan-gp"])
def test_multiscale_conditional_forms_match_jax(form, conditional, gan_type):
    """G and D stages with a D of two outputs and, with ``conditional``,
    the LR condition concatenated in front on the channels; wgan-gp with
    its penalty at JAX's alpha. Every log within 1e-5 of the critic's
    scale (0.1): a relativistic wgan loss is a difference of two means
    of that size, which cancels to 1e-3."""
    rng = np.random.RandomState(1)
    fake, real, cond = (rng.rand(3, 6, 6, 3).astype(np.float32)
                        for _ in range(3))
    kw = dict(gan_type=gan_type, form=form, conditional=conditional,
              gp_weight=10.0, use_featmaps=True)
    jl, tl = JaxAdversarial(**kw), AdversarialLoss(**kw)
    jax_d, torch_d = _critics(6 if conditional else 3)
    j = {k: jnp.asarray(v) for k, v in
         (("fake", fake), ("real", real), ("cond", cond))}
    t = {k: torch.from_numpy(v) for k, v in
         (("fake", fake), ("real", real), ("cond", cond))}
    _close(tl.generator_loss(torch_d, t["fake"], t["real"], t["cond"]),
           jl.generator_loss(jax_d, j["fake"], j["real"], j["cond"]),
           floor=0.1)
    key = jax.random.PRNGKey(3)
    want, wlogs = jl.discriminator_loss(jax_d, j["fake"], j["real"],
                                        j["cond"], gp_rng=key)
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))
    got, logs = tl.discriminator_loss(torch_d, t["fake"], t["real"],
                                      t["cond"],
                                      alpha=torch.from_numpy(alpha))
    assert set(logs) == set(wlogs)
    assert ("l_d_gp" in logs) == (gan_type == "wgan-gp")
    for k in wlogs:
        _close(logs[k], wlogs[k], floor=0.1)
    _close(got, want, floor=0.1)


def _d_pair(kind: str):
    """(flax module, its variables with redrawn biases, the port's D
    loaded from them), f32, 32 px."""
    if kind == "unet":
        jm, net = JaxUNet(nf=8), UNetDiscriminator(nf=8)
    else:
        jm = JaxVGG(size=32, base_nf=8, norm_type=None, spectral_norm=True)
        net = DiscriminatorVGG(size=32, base_nf=8, norm_type=None,
                               spectral_norm=True)
    v = _numpy(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                       train=False))
    rng = np.random.RandomState(3)
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if p[-1].key == "bias" else a, v["params"])
    net.load_state_dict(discriminator_from_jax(v["params"], v["batch_stats"]))
    return jm, v, net


@pytest.mark.parametrize("kind", ["unet", "vgg_sn"])
def test_gradient_penalty_and_d_gradients_match_jax(kind):
    """The D stage of wgan-gp (gp_weight 10) from one carried D and JAX's
    alpha: l_d_gp and the total within 1e-5, every D gradient (the
    penalty's double backward included) within 1e-4 of its tensor's
    largest; the spectral norms' state that the three passes leave equals
    the state one pass leaves."""
    jm, v, net = _d_pair(kind)
    rng = np.random.RandomState(7)
    fake = rng.rand(2, 32, 32, 3).astype(np.float32)
    real = rng.rand(2, 32, 32, 3).astype(np.float32)
    kw = dict(gan_type="wgan-gp", gp_weight=10.0)
    key = jax.random.PRNGKey(11)

    def jax_loss(params):
        def d_fn(x):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
            return out
        return JaxAdversarial(**kw).discriminator_loss(
            d_fn, jnp.asarray(fake), jnp.asarray(real), gp_rng=key)

    (want, wlogs), wgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        v["params"])
    alpha = torch.from_numpy(np.array(
        jax.random.uniform(key, (2, 1, 1, 1))))
    got, logs = AdversarialLoss(**kw).discriminator_loss(
        lambda x: net(x, train=True), torch.from_numpy(fake),
        torch.from_numpy(real), alpha=alpha)
    got.backward()
    _close(logs["l_d_gp"], wlogs["l_d_gp"])
    assert float(logs["l_d_gp"]) > 0
    _close(got, want)
    grads = discriminator_from_jax(_numpy(wgrads))
    named = dict(net.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        err = np.abs(named[k].grad.numpy() - g.numpy()).max()
        assert err <= 1e-4 * np.abs(g.numpy()).max() + 1e-9, (k, err)
    pending = {k: t.clone() for k, t in net.state_dict().items()}
    net.commit_stats()
    after_three = {k: t.clone() for k, t in net.state_dict().items()}
    net.load_state_dict(pending)
    net(torch.from_numpy(real), train=True)
    net.commit_stats()
    for k, t in net.state_dict().items():
        assert torch.equal(t, after_three[k]), k


def _vgg19_npz(path: str, seed: int = 4) -> str:
    """A converted-VGG19 file ('conv{b}_{c}/kernel' HWIO, '/bias') drawn
    from a numpy seed: He-scaled kernels, small biases."""
    rng = np.random.RandomState(seed)
    arrays, cin = {}, 3
    for b, n in enumerate((2, 2, 4, 4, 4), start=1):
        cout = 64 * min(2 ** (b - 1), 8)
        for c in range(1, n + 1):
            arrays[f"conv{b}_{c}/kernel"] = (rng.randn(3, 3, cin, cout)
                                             * np.sqrt(2.0 / (9 * cin))
                                             ).astype(np.float32)
            arrays[f"conv{b}_{c}/bias"] = (rng.randn(cout) * 0.01).astype(
                np.float32)
            cin = cout
    np.savez(path, **arrays)
    return path


STACK = {
    "pixel_criterion": "l1", "pixel_weight": 1e-2,
    "feature_criterion": "l1", "feature_weight": 1.0,
    "cx_weight": 0.5, "cx_type": "contextual",
    "hfen_weight": 1e-6, "hfen_criterion": "l1",
    "tv_type": "tv", "tv_weight": 1e-5,
    "ssim_type": "ms-ssim", "ssim_weight": 0.2,
    "lpips_weight": 0.5,
    "gan_type": "wgan-gp", "gan_weight": 5e-3, "gp_weight": 10,
}


def _stack_opt(vgg_path: str, d_spec: dict) -> dict:
    return {
        "is_train": True, "scale": 4, "path": {"vgg_weights": vgg_path},
        "network_G": {"type": "rrdb_net", "nf": 32, "nb": 2, "gc": 32,
                      "upscale": 4, "gaussian_noise": False},
        "network_D": d_spec,
        "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                  "optim_D": "sgd", "lr_scheme": "MultiStepLR",
                  "lr_steps": [50000], "D_update_ratio": 2, **STACK},
    }


def _redraw(params, seed, gain):
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return (rng.randn(*v.shape) * gain / np.sqrt(fan_in)).astype(
                np.float32)
        return (rng.randn(*v.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _numpy(params))


def test_three_full_stack_steps_match_jax(tmp_path):
    """G nf 32, nb 2, D-VGG with spectral norm (base_nf 8), batch 4, 8 ->
    32 px, f32, SGD, D_update_ratio 2: steps 0 and 2 update G and D, step
    1 only D. Every loss of the stack is on, wgan-gp's penalty included,
    each D stage fed the alpha the JAX step draws from its key. Every log
    within 1e-4 relative (D_real and D_fake, critic means near 0, against
    a floor of 0.3); D's spectral-norm state and G's and D's parameters
    within 1e-3 of each tensor's own move."""
    vgg = _vgg19_npz(os.path.join(tmp_path, "vgg19.npz"))
    opt = _stack_opt(vgg, {"type": "discriminator_vgg", "size": 32,
                           "base_nf": 8, "spectral_norm": True})
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    names = [e.name for e in jt.generator_loss.entries]
    assert names == ["l_g_pix", "l_g_fea", "l_g_cx", "l_g_lpips",
                     "l_g_HFEN", "l_g_tv", "l_g_ssim"]
    jt.generator_loss.entries[3].fn.model = JaxVGGFeatures(
        arch="vgg16", listen=LPIPS_RELU, use_input_norm=True)
    jstate = jt.init_state(jax.random.PRNGKey(0), (4, 8, 8, 3))
    jstate = jstate.replace(
        g=jstate.g.replace(params=_redraw(jstate.g.params, 1, 0.7)),
        d=jstate.d.replace(params=_redraw(jstate.d.params, 2, 1.0)))
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    assert [e.name for e in pt.generator_loss.entries] == names
    pstate = pt.init_state(0)
    load_train_state(pstate, train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step)))
    alphas = []
    discriminator_loss = pt.adversarial.discriminator_loss

    def with_jax_alpha(*args, **kw):
        kw["alpha"] = alphas.pop(0)
        return discriminator_loss(*args, **kw)

    pt.adversarial.discriminator_loss = with_jax_alpha
    rng = np.random.RandomState(0)
    batch = {"LR": rng.rand(4, 8, 8, 3).astype(np.float32),
             "HR": rng.rand(4, 32, 32, 3).astype(np.float32)}
    for step in range(3):
        r_gp = jax.random.split(jstate.rng, 5)[3]
        alphas.append(torch.from_numpy(np.array(
            jax.random.uniform(r_gp, (4, 1, 1, 1)))))
        old = train_state_from_jax(_numpy(jstate.g.params),
                                   _numpy(jstate.d.params),
                                   _numpy(jstate.d.extra["batch_stats"]), 0)
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, logs = pt.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert not alphas
        assert set(logs) == set(jlogs), step
        assert ("l_g_lpips" in logs) == (step % 2 == 0)
        assert float(logs["l_d_gp"]) > 0
        for k in jlogs:
            floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
            _close(logs[k], jlogs[k], 1e-4, floor)
        new = train_state_from_jax(_numpy(jstate.g.params),
                                   _numpy(jstate.d.params),
                                   _numpy(jstate.d.extra["batch_stats"]), 0)
        for which in ("g", "d"):
            got = getattr(pstate, which).net.state_dict()
            for k, want in new[which].items():
                moved = (want - old[which][k]).abs().max()
                err = (got[k] - want).abs().max()
                assert err <= 1e-3 * moved + 1e-6, (step, which, k, err)


def test_wgan_gp_with_a_batch_norm_d_is_refused():
    """The JAX step raises UnexpectedTracerError there; the port refuses
    at init and names ROADMAP C 18. Without gp_weight no penalty runs, and
    the same D trains, as in the JAX package."""
    opt = _stack_opt(None, {"type": "discriminator_vgg", "size": 32,
                            "base_nf": 8})
    opt["train"] = {k: v for k, v in opt["train"].items()
                    if k != "lpips_weight"}
    with pytest.raises(NotImplementedError, match="ROADMAP C 18"):
        SRTrainer(copy.deepcopy(opt), device="cpu").init_state(0)
    opt["train"]["gp_weight"] = None
    tr = SRTrainer(opt, dtype=torch.float32, device="cpu")
    state = tr.init_state(0)
    _, logs = tr.train_step(state, {"LR": torch.rand(2, 8, 8, 3),
                                    "HR": torch.rand(2, 32, 32, 3)})
    assert "l_d_gp" not in logs and np.isfinite(float(logs["l_d_total"]))
