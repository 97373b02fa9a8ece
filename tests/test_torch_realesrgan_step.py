"""The Real-ESRGAN training step: ``options/sr/train_realesrgan.yml`` at
debug width (G nf 16, nb 2, gc 8; the U-Net D with spectral norm at nf 8;
batch 4, 16 -> 64 px; EMA on), the port's ``SRTrainer`` against the JAX
package's on the CPU from one carried state: three consecutive steps (logs,
G's and D's parameters, D's spectral-norm state, the EMA weights),
``train_steps`` against three ``train_step`` calls, ``ema_update``'s
rounding, and ``eval_step``'s ``which``.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu.train.state import ema_update as jax_ema_update
from trainner_tpu_torch.options.config import read_yaml
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.train.state import ema_update, init_ema
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    params_to_jax,
                                                    train_state_from_jax,
                                                    vgg_from_jax)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
YML = ROOT / "options" / "sr" / "train_realesrgan.yml"
BATCH, LR_PX = 4, 16


def debug_options(**train) -> dict:
    """``train_realesrgan.yml`` at debug width, latent noise off (its
    streams cannot match between the frameworks)."""
    opt = read_yaml(str(YML))
    opt.update(is_train=True, use_amp=False)
    opt["network_G"].update(nf=16, nb=2, gc=8, gaussian_noise=False)
    opt["network_D"].update(nf=8)
    opt["train"].update(train)
    return opt


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _redraw(params, seed, gain):
    """Kernels at ``gain / sqrt(fan_in)`` and small non-zero biases from a
    numpy seed (the default init leaves G's output near 1e-4)."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return (rng.randn(*v.shape) * gain / np.sqrt(fan_in)).astype(
                np.float32)
        return (rng.randn(*v.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _numpy(params))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"LR": rng.rand(BATCH, LR_PX, LR_PX, 3).astype(np.float32),
            "HR": rng.rand(BATCH, LR_PX * 4, LR_PX * 4, 3).astype(np.float32)}


def _carried(jstate):
    return train_state_from_jax(
        _numpy(jstate.g.params), _numpy(jstate.d.params),
        _numpy(jstate.d.extra["batch_stats"]), int(jstate.step),
        ema_params=_numpy(jstate.ema_params))


def pair(opt):
    """The two trainers on one state: the JAX state with redrawn weights
    (the EMA weights a copy of G's), the port's loaded from it, the JAX
    side's random VGG carried across."""
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (BATCH, LR_PX, LR_PX, 3))
    g = _redraw(jstate.g.params, 1, 0.7)
    jstate = jstate.replace(g=jstate.g.replace(params=g),
                            d=jstate.d.replace(params=_redraw(
                                jstate.d.params, 2, 1.0)),
                            ema_params=jax.tree.map(np.copy, g))
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    load_train_state(pstate, _carried(jstate))
    vgg = _numpy(jt.generator_loss.entries[1].fn.variables["params"])
    pt.generator_loss.entries[1].fn.model.load_state_dict(
        vgg_from_jax(vgg), strict=False)
    return jt, jstate, pt, pstate


def _port(pstate):
    return {"g": {k: v.detach().numpy().copy()
                  for k, v in pstate.g.net.state_dict().items()},
            "d": {k: v.detach().numpy().copy()
                  for k, v in pstate.d.net.state_dict().items()},
            "ema": {k: v.detach().numpy().copy()
                    for k, v in pstate.ema_params.items()}}


def _jax(jstate):
    c = _carried(jstate)
    return {w: {k: v.numpy() for k, v in c[w].items()}
            for w in ("g", "d", "ema")}


def test_three_realesrgan_steps_match_jax():
    """f32, adam at lr 1e-4, the config's losses, D and EMA: every log
    within 1e-4 relative at the first step and 2e-3 after (floor 0.3 for
    D's mean logits, 1e-3 for the losses), as in
    ``test_torch_train_step.py``; every parameter element (G, D, and the
    EMA weights, which move by 1 - decay of G's moves) within 2 lr per
    step, all but 0.1 % of each tensor within 0.02 lr per step (D's
    output bias, whose gradient is rounding alone, to the first bound
    only); the EMA weights' moves from the start within 1e-2 of their norm
    (a skipped or misordered update misses by half or more); D's ``u`` and
    ``sigma`` within 1e-5 relative to their size."""
    lr = 1e-4
    jt, jstate, pt, pstate = pair(debug_options())
    assert pt.use_ema and pt.ema_decay == 0.999
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    e0 = _port(pstate)["ema"]
    for step in range(3):
        jstate, jlogs = jt.train_step(jstate, jb)
        pstate, logs = pt.train_step(pstate, tb)
        assert set(logs) == set(jlogs)
        rel = 1e-4 if step == 0 else 2e-3
        for k in jlogs:
            got, want = float(logs[k]), float(jlogs[k])
            floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
            assert np.isfinite(got) and \
                abs(got - want) <= rel * max(abs(want), floor), \
                (step, k, got, want)
        got, new = _port(pstate), _jax(jstate)
        for which in ("g", "d", "ema"):
            assert set(got[which]) == set(new[which]), which
            for k, want in new[which].items():
                err = np.abs(got[which][k] - want)
                if ".sn." in k:
                    assert err.max() <= 1e-5 * np.abs(want).max(), (step, k)
                    continue
                assert err.max() <= 2 * lr * (step + 1), (step, which, k)
                far = (err > 0.02 * lr * (step + 1)).mean()
                # D's output bias: the relativistic loss does not change
                # when every logit shifts, so its gradient is rounding
                # alone, held by the 2 lr bound only
                noise_only = which == "d" and k == "conv9.bias"
                assert noise_only or far <= 1e-3, (step, which, k, far)
        # the bounds above are 1 / (1 - decay) times what the EMA weights
        # move: their moves from the start agree within 1e-2 of their norm
        for k, want in new["ema"].items():
            moved = want - e0[k]
            err = np.linalg.norm(got["ema"][k] - e0[k] - moved)
            assert err <= 1e-2 * np.linalg.norm(moved), (step, k)
    # the EMA weights lag G's: after three steps they moved by about
    # 3 (1 - decay) of G's moves
    g0 = pair(debug_options())[3].g.net.state_dict()
    key = "conv_first.weight"
    moved_g = (pstate.g.net.state_dict()[key] - g0[key]).abs().max()
    moved_e = (pstate.ema_params[key] - g0[key]).abs().max()
    assert 0 < moved_e < 0.01 * moved_g


def test_train_steps_with_ema_equal_three_train_steps():
    """The k-step window with EMA against k ``train_step`` calls, bit for
    bit: logs, parameters, D's state and the EMA weights."""
    opt = debug_options()
    batches = [_batch(s) for s in range(3)]
    a = SRTrainer(copy.deepcopy(opt), device="cpu")
    sa = a.init_state(3)
    logs_a = [a.train_step(sa, {k: torch.from_numpy(v)
                                for k, v in b.items()})[1] for b in batches]
    b = SRTrainer(copy.deepcopy(opt), device="cpu")
    sb = b.init_state(3)
    sb, logs_b = b.train_steps(sb, {k: torch.from_numpy(np.stack(
        [bt[k] for bt in batches])) for k in ("LR", "HR")})
    assert sa.step == sb.step == 3
    for k in logs_b:
        assert torch.equal(logs_b[k], torch.stack([lg[k] for lg in logs_a]))
    for which in ("g", "d", "ema"):
        pa, pb = _port(sa)[which], _port(sb)[which]
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("decay", [0.999, 0.9, 0.5])
def test_ema_update_rounds_as_jax(decay):
    """decay e + (1 - decay) p in f32 bit for bit with the JAX package's
    ``ema_update`` under jit, as its step runs it: (1 - decay) p rounded,
    then decay e plus that rounded once (XLA fuses the two)."""
    from trainner_tpu.train.state import NetState as JaxNet
    from trainner_tpu.train.state import SRTrainState as JaxState
    from trainner_tpu_torch.train.state import NetState, SRTrainState

    rng = np.random.RandomState(0)
    e = rng.randn(4096).astype(np.float32)
    p = rng.randn(4096).astype(np.float32)
    jstate = JaxState(step=jnp.zeros([], jnp.int32), rng=None,
                      g=JaxNet(params={"w": jnp.asarray(p)}),
                      ema_params={"w": jnp.asarray(e)})
    # under jit, as the JAX trainer's step runs it
    want = jax.jit(lambda s: jax_ema_update(s, decay))(jstate)
    net = torch.nn.Linear(1, 1, bias=False)
    net.weight = torch.nn.Parameter(torch.from_numpy(e.copy()))
    state = SRTrainState(step=0, g=NetState(net))
    init_ema(state)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(p))
    ema_update(state, decay)
    np.testing.assert_array_equal(state.ema.weight.numpy(),
                                  np.asarray(want.ema_params["w"]))


def test_eval_step_which():
    """``eval_step`` runs the EMA weights for 'auto' and 'ema' when the
    state has them, G for 'g' (and for 'swa', SWA not being kept), as the
    JAX package's does; the JAX ``eval_step`` on the same weights agrees
    within 1e-5 for each."""
    jt, jstate, pt, pstate = pair(debug_options())
    # make the EMA weights differ from G's
    with torch.no_grad():
        for p in pstate.ema.parameters():
            p.mul_(0.9)
    jstate = jstate.replace(ema_params=jax.tree.map(
        lambda v: np.asarray(v) * np.float32(0.9), _numpy(jstate.ema_params)))
    lr = _batch(2)["LR"][:2]
    outs = {}
    for which in ("auto", "ema", "g", "swa"):
        got = pt.eval_step(pstate, torch.from_numpy(lr), which=which).numpy()
        want = np.asarray(jt.eval_step(jstate, jnp.asarray(lr), which=which))
        assert np.abs(got - want).max() <= 1e-5, which
        outs[which] = got
    np.testing.assert_array_equal(outs["auto"], outs["ema"])
    np.testing.assert_array_equal(outs["g"], outs["swa"])
    assert not np.array_equal(outs["g"], outs["ema"])
    with pytest.raises(ValueError, match="which"):
        pt.eval_step(pstate, torch.from_numpy(lr), which="best")


def test_eval_step_ema_follows_training():
    """``eval_step`` of the EMA weights after a step runs the weights as
    that step left them, not those packed at an earlier evaluation: train,
    evaluate, train, evaluate; the second evaluation equals, bit for bit, a
    fresh copy of G loaded with the EMA weights of now, and the JAX
    ``eval_step`` on those weights within 1e-5. Decay 0.5, so that a step
    moves the EMA weights as far as it moves G's."""
    jt, jstate, pt, pstate = pair(debug_options(ema_decay=0.5))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    lr = torch.from_numpy(_batch(2)["LR"][:2])
    first = pt.eval_step(pstate, lr, which="ema")
    pt.train_step(pstate, batch)
    pt.eval_step(pstate, lr, which="ema")
    pt.train_step(pstate, batch)
    got = pt.eval_step(pstate, lr, which="ema")
    net = copy.deepcopy(pstate.g.net)
    net.load_state_dict(pstate.ema.state_dict())
    with torch.inference_mode():
        want = net.eval()(lr).float()
    assert torch.equal(got, want)
    assert (got - first).abs().max() > 1e-4
    jstate = jstate.replace(ema_params=params_to_jax(
        {k: v.detach() for k, v in pstate.ema.state_dict().items()}))
    jwant = np.asarray(jt.eval_step(jstate, jnp.asarray(lr.numpy()),
                                    which="ema"))
    assert np.abs(got.numpy() - jwant).max() <= 1e-5
