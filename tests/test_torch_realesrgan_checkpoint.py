"""Checkpoints of the Real-ESRGAN configuration (the U-Net D with its
spectral-norm state, the EMA weights) in the JAX package's format, both
ways: the port's ``.state`` tree is the JAX tree, a port ``.state`` loads
in the JAX package with equal values, a JAX ``.state`` resumes in the port
beside JAX's next step, ``{tag}_emaG.ckpt`` is written and reads back as
the EMA weights, and a port save and resume restores the EMA and
spectral-norm state bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from test_torch_realesrgan_step import _batch, _jax, _port, debug_options, \
    pair
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (params_from_jax,
                                                    train_state_to_jax)

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tb(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def test_the_state_tree_is_the_jax_tree():
    """``train_state_to_jax`` of a Real-ESRGAN state has exactly the keys,
    shapes and types of the JAX ``SRTrainState``'s: the U-Net's params and
    its ``SpectralNorm_{i}`` batch stats, and ``ema_params``."""
    jt, jstate, pt, pstate = pair(debug_options())
    want = _flat(serialization.msgpack_restore(
        serialization.to_bytes(jstate)))
    got = _flat(C.msgpack_restore(C.msgpack_serialize(
        train_state_to_jax(pstate))))
    assert set(got) == set(want)
    assert any("SpectralNorm_8" in k for k in want)
    assert any(k.startswith("/ema_params/") for k in want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k


def test_port_state_loads_in_jax_with_equal_values(tmp_path):
    """A port ``.state`` after one step -> the JAX ``load_state`` on a
    fresh JAX state: every leaf (the spectral norms' u and sigma and the
    EMA weights included) equals the port's."""
    jt, jstate, pt, pstate = pair(debug_options())
    pstate, _ = pt.train_step(pstate, _tb())
    path = str(tmp_path / "1.state")
    C.save_state(pstate, path, epoch=2)
    loaded, meta = JC.load_state(path, jstate)
    assert meta["iter"] == 1 and int(loaded.step) == 1
    want = _flat(train_state_to_jax(pstate))
    got = _flat(serialization.to_state_dict(loaded))
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_a_jax_state_resumes_in_the_port(tmp_path):
    """A JAX ``save_state`` file after one step, resumed in a fresh port
    trainer: its spectral-norm state and EMA weights load exactly, and the
    next step beside JAX's holds the step-parity tolerances of
    ``test_torch_realesrgan_step.py``."""
    lr = 1e-4
    jt, jstate, pt, _ = pair(debug_options())
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jstate, _ = jt.train_step(jstate, jb)
    path = str(tmp_path / "1.state")
    JC.save_state(jstate, path, epoch=0)
    pstate, meta = C.load_state(path, pt.init_state(7))
    assert pstate.step == 1 == meta["iter"]
    loaded, want = _port(pstate), _jax(jstate)
    for which in ("d", "ema"):
        for k, v in want[which].items():
            np.testing.assert_array_equal(loaded[which][k], v, err_msg=k)
    jstate, _ = jt.train_step(jstate, jb)
    pstate, _ = pt.train_step(pstate, _tb())
    got, new = _port(pstate), _jax(jstate)
    for which in ("g", "d", "ema"):
        for k, v in new[which].items():
            err = np.abs(got[which][k] - v)
            if ".sn." in k:
                assert err.max() <= 1e-5 * np.abs(v).max(), k
            else:
                assert err.max() <= 2 * lr, (which, k)


def test_ema_checkpoint_file(tmp_path):
    """``save_checkpoint`` writes ``{iter}_emaG.ckpt`` beside G and D, in
    G's flax layout: the JAX ``load_params`` reads it and it holds the EMA
    weights, not G's."""
    trainer = SRTrainer(debug_options(), device="cpu")
    state = trainer.init_state(0)
    state, _ = trainer.train_step(state, _tb())
    opt = {"path": {"models": str(tmp_path / "models"),
                    "training_state": str(tmp_path / "training_state")}}
    C.save_checkpoint(state, opt, epoch=0, niter=1)
    names = sorted(p.name for p in (tmp_path / "models").iterdir())
    assert names == ["1_D.ckpt", "1_G.ckpt", "1_emaG.ckpt"]
    ema = params_from_jax(JC.load_params(str(tmp_path / "models" /
                                             "1_emaG.ckpt")))
    for k, v in state.ema_params.items():
        torch.testing.assert_close(ema[k], v.detach(), atol=0, rtol=0)
    assert not torch.equal(ema["conv_first.weight"],
                           state.g.net.conv_first.weight.detach())


def test_save_and_resume_restores_ema_and_sn_bit_for_bit(tmp_path):
    """Two steps and a checkpoint; a fresh trainer loads it: G, D (its
    spectral norms' u and sigma included), the EMA weights and the moments
    equal the saved ones bit for bit, and two more steps from each agree
    within 1e-6."""
    batches = [_tb(s) for s in range(4)]
    trainer = SRTrainer(debug_options(), device="cpu")
    state = trainer.init_state(0)
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    opt = {"path": {"models": str(tmp_path / "models"),
                    "training_state": str(tmp_path / "training_state")}}
    C.save_checkpoint(state, opt, epoch=0, niter=2)
    saved = _port(state)
    fresh = SRTrainer(debug_options(), device="cpu")
    resumed, _ = C.load_state(str(tmp_path / "training_state" / "2.state"),
                              fresh.init_state(5))
    loaded = _port(resumed)
    for which in ("g", "d", "ema"):
        assert set(loaded[which]) == set(saved[which])
        for k, v in saved[which].items():
            np.testing.assert_array_equal(loaded[which][k], v,
                                          err_msg=f"{which} {k}")
    assert any(".sn.u" in k for k in saved["d"])
    for a, b in zip(state.d.opt.mu + state.d.opt.nu,
                    resumed.d.opt.mu + resumed.d.opt.nu):
        assert torch.equal(a, b)
    for b in batches[2:]:
        state, _ = trainer.train_step(state, b)
        resumed, _ = fresh.train_step(resumed, b)
    after, after_r = _port(state), _port(resumed)
    for which in ("g", "d", "ema"):
        for k, v in after[which].items():
            np.testing.assert_allclose(after_r[which][k], v, atol=1e-6,
                                       rtol=0, err_msg=f"{which} {k}")
