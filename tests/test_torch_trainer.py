"""The port's trainer on its own (``trainner_tpu_torch/train/
sr_trainer.py``): wire batches, the train-mode latent noise and its
generator, what the G stage leaves on D, the factory's defaults. The
parity with the JAX trainer is in ``test_torch_train_step.py`` (the other
trainer options in ``test_torch_trainer_options.py`` and
``test_torch_options_steps.py``); this file imports no JAX, so its steps
run at the CPU's full speed.
"""

import numpy as np
import pytest
import torch

from trainner_tpu_torch.models.rrdb import RRDBNet
from trainner_tpu_torch.ops.blocks import GaussianNoise
from trainner_tpu_torch.train.sr_trainer import SRTrainer, create_trainer

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)

BATCH, LR_PX = 4, 8


def _opt(optim="adam", lr=1e-4, ratio=2, **train):
    return {
        "is_train": True, "scale": 4,
        "network_G": {"type": "rrdb_net", "nf": 32, "nb": 2, "gc": 32,
                      "upscale": 4, "gaussian_noise": False},
        "network_D": {"type": "discriminator_vgg", "size": 32, "base_nf": 8},
        "train": {
            "lr_G": lr, "lr_D": lr, "optim_G": optim, "optim_D": optim,
            "pixel_criterion": "l1", "pixel_weight": 1e-2,
            "feature_criterion": "l1", "feature_weight": 1.0,
            "gan_type": "vanilla", "gan_weight": 5e-3,
            "lr_scheme": "MultiStepLR", "lr_steps": [50000],
            "D_update_ratio": ratio, **train},
    }


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"LR": rng.rand(BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(BATCH, LR_PX * 4, LR_PX * 4, 3).astype(np.float32)}


def test_uint8_batches_are_normalised_on_the_device():
    pt = SRTrainer(_opt(ratio=1), dtype=torch.float32, device="cpu")
    state = pt.init_state(3)
    batch = _batch(2)
    as_u8 = {k: torch.from_numpy((v * 255).round().astype(np.uint8))
             for k, v in batch.items()}
    as_f = {k: v.float() / 255.0 for k, v in as_u8.items()}
    _, logs_u8 = pt.train_step(state, as_u8)
    _, logs_f = pt.train_step(pt.init_state(3), as_f)
    for k in logs_f:
        assert abs(float(logs_u8[k]) - float(logs_f[k])) < 1e-6


def test_noise_is_relative_detached_and_drawn_from_the_generator():
    """Train mode: x + 0.1 * x.detach() * randn. The noise has mean 0 and
    standard deviation sigma * |x|, no gradient flows through the scale, a
    second call draws anew, the same generator state gives the same draw;
    eval mode is the identity."""
    noise = GaussianNoise(0.1).train()
    noise.generator = torch.Generator().manual_seed(0)
    x = torch.full((64, 8, 16, 16), 3.0, requires_grad=True)
    y = noise(x)
    rel = ((y - x) / x).detach()
    assert abs(float(rel.mean())) < 1e-3      # 131,072 draws of std 0.1
    assert abs(float(rel.std()) - 0.1) < 1e-3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert not torch.equal(noise(x), y)
    noise.generator.manual_seed(0)
    assert torch.equal(noise(x), y)
    assert noise.eval()(x) is x


def test_trainer_owns_the_noise_generator():
    """With gaussian_noise on, every noise layer of G draws from the
    state's generator: the same seed gives the same step, the step after
    another draw."""
    opt = _opt(ratio=1)
    opt["network_G"]["gaussian_noise"] = True
    pt = SRTrainer(opt, dtype=torch.float32, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    a = pt.init_state(5)
    layers = [m for m in a.g.net.modules() if isinstance(m, GaussianNoise)]
    assert len(layers) == 6 and all(m.generator is a.noise_generator
                                    for m in layers)
    _, logs_a = pt.train_step(a, batch)
    _, logs_b = pt.train_step(pt.init_state(5), batch)
    assert float(logs_a["l_g_pix"]) == float(logs_b["l_g_pix"])
    _, logs_a2 = pt.train_step(a, batch)
    assert float(logs_a2["l_g_pix"]) != float(logs_a["l_g_pix"])


def test_g_stage_leaves_no_gradient_on_d_and_keeps_its_statistics():
    """A step without a D update cannot happen with a GAN loss, so look
    inside: after the G stage alone D has no .grad and its running
    statistics are untouched."""
    pt = SRTrainer(_opt(ratio=1), dtype=torch.float32, device="cpu")
    state = pt.init_state(1)
    before = {k: v.clone() for k, v in state.d.net.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    pt._train_step(state, batch, 1e-4, 1e-4, update_d=False, update_g=True)
    assert all(p.grad is None for p in state.d.net.parameters())
    assert all(p.requires_grad for p in state.d.net.parameters())
    for k, v in state.d.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_create_trainer_trains_in_bf16_on_the_card_by_default(monkeypatch):
    """is_train no longer raises; the default is bf16 on cuda, and without
    a card it raises instead of running on the CPU."""
    tr = create_trainer(_opt(), device="cpu")
    assert tr.dtype == torch.bfloat16 and tr.use_gan
    assert create_trainer({**_opt(), "use_amp": False},
                          device="cpu").dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_trainer(_opt())


def test_inference_trainer_refuses_to_train():
    opt = {**_opt(), "is_train": False}
    tr = create_trainer(opt, device="cpu")
    assert tr.dtype == torch.float32 and tr.generator_loss is None
    state = tr.init_state(0)
    assert isinstance(state.g.net, RRDBNet) and state.d is None
    assert tr.eval_step(state, torch.rand(1, 4, 4, 3)).shape == (1, 16, 16, 3)
    with pytest.raises(RuntimeError, match="is_train"):
        tr.train_step(state, {})
