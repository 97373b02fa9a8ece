"""Checkpoints of the port (``trainner_tpu_torch/utils/checkpoint.py``) in
the JAX package's format, both ways: the msgpack writer against flax's
bytes, the port's ``{tag}_G.ckpt`` and ``.state`` read by the JAX
package's ``load_params`` / ``load_state``, a JAX ``.state`` resumed in the
port (the next two steps beside JAX's), a port save and resume against an
uninterrupted run, ``latest_state_path``, and the serialized optimizer
state that ``_moments_from_jax`` reads."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_train_step import (_batch, _check_logs, _jax_tensors, _opt,
                                   _pair, _port_tensors, _redraw)
from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu.utils import checkpoint as JC
from trainner_tpu_torch.models.rrdb import RRDBNet
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils import checkpoint as C
from trainner_tpu_torch.utils.torch_interop import (
    _moments_from_jax, key_to_seed, load_train_state, params_from_jax,
    params_to_jax, seed_to_key, train_state_from_jax,
    train_state_from_state_dict, train_state_to_jax)

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the msgpack writer
# ---------------------------------------------------------------------------

DTYPES = ["float32", "float64", "float16", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_msgpack_round_trip_and_flax_bytes(dtype):
    """Arrays of every dtype, 0-d arrays and numpy scalars, in a tree with
    None, strings, numbers, empty maps and lists: the port writes flax's
    bytes, byte for byte, and reads them back equal."""
    rng = np.random.RandomState(0)
    arr = (rng.randn(3, 4, 5) * 50).astype(dtype)
    tree = {"z": arr, "a": {"scalar": np.asarray(arr.flat[0]),
                            "np": arr.dtype.type(arr.flat[1]),
                            "big": np.resize(arr, (70, 9))},
            "none": None, "name": "x" * 40, "n": 3, "neg": -70000,
            "f": 0.5, "t": True, "empty": {}, "list": [1, "two"]}
    data = C.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = C.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    for k, v in _flat(want).items():
        got = _flat(back)[k]
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v)
        else:
            assert got == v, k


def test_msgpack_refuses_what_flax_would_chunk_or_cannot_write():
    with pytest.raises(TypeError):
        C.msgpack_serialize({"t": torch.zeros(2)})
    with pytest.raises(ValueError):
        C.msgpack_serialize({"o": np.array([object()])})


# ---------------------------------------------------------------------------
# the port's files read by the JAX package
# ---------------------------------------------------------------------------

G_OPT = {"nf": 32, "nb": 2, "nr": 3, "gc": 16, "upscale": 4}


def test_port_g_checkpoint_loads_in_jax_and_runs_alike(tmp_path):
    """``{tag}_G.ckpt`` of the port -> the JAX ``load_params(path,
    target)``; the JAX G forward on it equals the port's (f32, 1e-5)."""
    jnet = JaxRRDBNet(in_nc=3, out_nc=3, gaussian_noise=False, **G_OPT)
    x = np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32)
    target = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    net = RRDBNet(in_nc=3, out_nc=3, gaussian_noise=False, **G_OPT)
    net.load_state_dict(params_from_jax(_redraw(target, 3, 0.7)))
    path = str(tmp_path / "12_G.ckpt")
    C.save_params(params_to_jax(net.state_dict()), path)
    loaded = JC.load_params(path, target)
    want = np.asarray(jnet.apply({"params": loaded}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and the port reads its own file back to the same state_dict
    back = C.load_params(path)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


def test_port_state_loads_in_jax_with_equal_values(tmp_path):
    """A port ``.state`` after one step (Adam moments, count 1, D's running
    statistics moved) -> the JAX ``load_state(path, template)`` on a fresh
    JAX state: every leaf equals the port's, and the sidecar's iter."""
    jt, jstate, pt, pstate = _pair(_opt("adam"), jnp.float32, torch.float32)
    pstate, _ = pt.train_step(pstate, {k: torch.from_numpy(v)
                                       for k, v in _batch().items()})
    path = str(tmp_path / "1.state")
    C.save_state(pstate, path, epoch=3)
    loaded, meta = JC.load_state(path, jstate)
    assert meta["epoch"] == 3 and meta["iter"] == 1
    assert int(loaded.step) == 1 and int(loaded.g.opt_state[0].count) == 1
    want = _flat(train_state_to_jax(pstate))
    got = _flat(serialization.to_state_dict(loaded))
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    # the key the port wrote is one that JAX resumes with
    jax.random.split(loaded.rng)


def test_a_jax_state_resumes_in_the_port(tmp_path):
    """A JAX ``save_state`` file after one step, resumed in a fresh port
    trainer: the next two steps (adam, D_update_ratio 2: the second has no
    G update) beside JAX's own, within the step-parity tolerances of
    ``tests/test_torch_train_step.py``."""
    lr = 1e-4
    jt, jstate, pt, _ = _pair(_opt("adam", lr), jnp.float32, torch.float32)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstate, _ = jt.train_step(jstate, jbatch)
    path = str(tmp_path / "1.state")
    JC.save_state(jstate, path, epoch=0)
    pstate = pt.init_state(7)
    pstate, meta = C.load_state(path, pstate)
    assert pstate.step == 1 == meta["iter"]
    assert pstate.g.opt.count == 1 and pstate.d.opt.count == 1
    np.testing.assert_array_equal(pstate.rng, np.asarray(jstate.rng))
    for step in (1, 2):
        jstate, jlogs = jt.train_step(jstate, jbatch)
        pstate, logs = pt.train_step(pstate, tbatch)
        _check_logs(logs, jlogs, 2e-3, step)
        new, got = _jax_tensors(jstate), _port_tensors(pstate)
        for which in ("g", "d"):
            # updates since the two states were equal: D one per step, G
            # one in all (at step 2)
            n_steps = 1 if which == "g" else step
            for k, want in new[which].items():
                err = np.abs(got[which][k] - want)
                if "running_" in k:
                    assert err.max() <= 1e-3 * np.abs(want).max(), k
                    continue
                noise_only = which == "d" and k.endswith("bias") and (
                    k.startswith("linear")
                    or k.replace("bias", "norm.weight") in new[which])
                assert err.max() <= 2 * lr * n_steps, (step, which, k)
                assert noise_only or (err > 0.02 * lr * n_steps).mean() \
                    <= 1e-3, (step, which, k)


def _noisy_opt():
    opt = _opt("adam", ratio=1)
    opt["network_G"]["gaussian_noise"] = True
    return opt


def test_save_and_resume_continues_as_one_run(tmp_path):
    """Two steps, a checkpoint, two more steps; against a fresh trainer
    that loads the checkpoint and takes the same two steps: G's parameters
    within 1e-6 (latent noise on: its generator's state is in the sidecar),
    D's tensors and the moments alike."""
    batches = [{k: torch.from_numpy(v) for k, v in _batch(s).items()}
               for s in range(4)]
    trainer = SRTrainer(_noisy_opt(), device="cpu")
    state = trainer.init_state(0)
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    opt = {"path": {"models": str(tmp_path / "models"),
                    "training_state": str(tmp_path / "training_state")}}
    C.save_checkpoint(state, opt, epoch=1, niter=2)
    for b in batches[2:]:
        state, _ = trainer.train_step(state, b)

    fresh_trainer = SRTrainer(_noisy_opt(), device="cpu")
    resumed = fresh_trainer.init_state(5)
    resumed, meta = C.load_state(str(tmp_path / "training_state" /
                                     "2.state"), resumed)
    assert meta == {"epoch": 1, "iter": 2,
                    "noise_generator": meta["noise_generator"]}
    for b in batches[2:]:
        resumed, _ = fresh_trainer.train_step(resumed, b)
    assert resumed.step == state.step == 4
    for k, v in state.g.net.state_dict().items():
        torch.testing.assert_close(resumed.g.net.state_dict()[k], v,
                                   atol=1e-6, rtol=0)
    for k, v in state.d.net.state_dict().items():
        torch.testing.assert_close(resumed.d.net.state_dict()[k], v,
                                   atol=1e-6, rtol=0)
    for a, b in zip(state.g.opt.mu + state.g.opt.nu,
                    resumed.g.opt.mu + resumed.g.opt.nu):
        torch.testing.assert_close(a, b, atol=1e-9, rtol=0)
    assert resumed.g.opt.count == state.g.opt.count == 4


def test_save_checkpoint_names_and_backups(tmp_path):
    trainer = SRTrainer(_opt(), device="cpu")
    state = trainer.init_state(0)
    opt = {"path": {"models": str(tmp_path / "m"),
                    "training_state": str(tmp_path / "s")}}
    C.save_checkpoint(state, opt, epoch=0, niter=6)
    C.save_checkpoint(state, opt, epoch=0, niter=6)  # again: backups
    C.save_checkpoint(state, opt, epoch=0, niter=9, latest_only=True)
    assert sorted(os.listdir(tmp_path / "m")) == [
        "6_D.ckpt", "6_G.ckpt", "latest_D.ckpt", "latest_G.ckpt",
        "previous_6_D.ckpt", "previous_6_G.ckpt"]
    assert sorted(os.listdir(tmp_path / "s")) == [
        "6.state", "6.state.json", "latest.state", "latest.state.json",
        "previous_6.state"]
    with open(tmp_path / "s" / "6.state.json") as f:
        assert json.load(f)["iter"] == 0
    # D's file holds D's params alone, as the JAX trainer writes it
    d_tree = C.msgpack_restore((tmp_path / "m" / "6_D.ckpt").read_bytes())
    assert "conv0_0" in d_tree and "batch_stats" not in d_tree


def test_latest_state_path_skips_backups_and_ranks_by_iteration(tmp_path):
    d = tmp_path / "training_state"
    d.mkdir()
    for name in ("8.state", "12.state", "previous_99.state", "latest.state",
                 "100.state.json"):
        (d / name).write_bytes(b"")
    (d / "latest.state.json").write_text(json.dumps({"iter": 10}))
    for f in (C.latest_state_path, JC.latest_state_path):
        assert f(str(d)) == str(d / "12.state")
    (d / "latest.state.json").write_text(json.dumps({"iter": 13}))
    assert C.latest_state_path(str(d)) == str(d / "latest.state")
    assert C.latest_state_path(str(tmp_path / "none")) is None


def test_moments_from_a_serialized_jax_opt_state():
    """In a ``.state`` file the optax chain state is a dict keyed "0"
    (``{"0": {count, mu, nu}}``, and "1" under weight decay); the parent
    read only the live tuple and failed on it."""
    jt, jstate, _, _ = _pair(_opt("adam"), jnp.float32, torch.float32)
    tree = serialization.msgpack_restore(serialization.to_bytes(jstate))
    assert set(tree["g"]["opt_state"]) == {"0"}
    moments = _moments_from_jax(tree["g"]["opt_state"], params_from_jax)
    assert moments["count"] == 0
    assert set(moments["mu"]) == set(moments["nu"]) == set(
        params_from_jax(tree["g"]["params"]))
    chain = {"0": {"count": np.asarray(3, np.int32),
                   "mu": {"w": np.ones(2)}, "nu": {"w": np.zeros(2)}},
             "1": {}}
    got = _moments_from_jax(chain, lambda t: t)
    assert got["count"] == 3 and got["mu"]["w"].sum() == 2
    sgd = _moments_from_jax({"0": {"trace": {"w": np.ones(2)}}},
                            lambda t: t)
    assert sgd["count"] == 0 and "trace" in sgd
    carried = train_state_from_state_dict(tree)
    assert carried["step"] == 0 and carried["d_opt"]["count"] == 0


@pytest.mark.parametrize("optim, wd", [("adam", 0.0), ("adam", 1e-2),
                                       ("sgd", 0.0)])
def test_the_state_tree_is_the_jax_tree(optim, wd):
    """``train_state_to_jax`` has exactly the keys and shapes of the JAX
    ``SRTrainState``'s state dict, the optimizer chain included."""
    opt = _opt(optim, weight_decay_G=wd, weight_decay_D=wd)
    jt, jstate, pt, pstate = _pair(opt, jnp.float32, torch.float32)
    want = _flat(serialization.msgpack_restore(
        serialization.to_bytes(jstate)))
    got = _flat(C.msgpack_restore(C.msgpack_serialize(
        train_state_to_jax(pstate))))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k


def test_key_and_seed_rule():
    for seed in (0, 2, 12345):
        np.testing.assert_array_equal(seed_to_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    key = np.array([7, 9], np.uint32)
    assert key_to_seed(key) == (7 << 32) | 9
    np.testing.assert_array_equal(seed_to_key(key_to_seed(key)), key)
    trainer = SRTrainer(_noisy_opt(), device="cpu")
    state = trainer.init_state(4)
    assert key_to_seed(state.rng) == 6
    a = torch.randn(3, generator=state.noise_generator)
    b = torch.randn(3, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b)


def _storage(state):
    """Every tensor a captured step reads or writes, by name -> data_ptr:
    parameters and buffers of G and D, the optimizers' count and moments."""
    out = {}
    for which in ("g", "d"):
        ns = getattr(state, which)
        for k, v in ns.net.state_dict().items():
            out[f"{which}.{k}"] = v.data_ptr()
        out[f"{which}.count"] = ns.opt.count.data_ptr()
        for i, t in enumerate(ns.opt.mu + ns.opt.nu):
            out[f"{which}.moment{i}"] = t.data_ptr()
    return out


def test_a_resume_writes_into_the_captured_tensors(tmp_path):
    """``load_state`` (a port checkpoint) and ``load_train_state`` (a JAX
    state carried across) write into the state's own tensors: every
    parameter, buffer, moment and count keeps its storage, and the
    latent-noise generator stays the same object, reseeded. So a CUDA
    graph captured before a resume keeps reading and writing the resumed
    state. The values are the saved ones, bit for bit."""
    batches = [{k: torch.from_numpy(v) for k, v in _batch(s).items()}
               for s in range(2)]
    trainer = SRTrainer(_noisy_opt(), device="cpu")
    state = trainer.init_state(0)
    for b in batches:
        state, _ = trainer.train_step(state, b)
    opt = {"path": {"models": str(tmp_path / "models"),
                    "training_state": str(tmp_path / "training_state")}}
    C.save_checkpoint(state, opt, epoch=0, niter=2)

    resumed = trainer.init_state(5)
    ptrs, gen = _storage(resumed), resumed.noise_generator
    resumed, _ = C.load_state(str(tmp_path / "training_state" / "2.state"),
                              resumed)
    assert _storage(resumed) == ptrs and resumed.noise_generator is gen
    for which in ("g", "d"):
        mine = getattr(resumed, which)
        theirs = getattr(state, which)
        for k, v in theirs.net.state_dict().items():
            assert torch.equal(mine.net.state_dict()[k], v), k
        assert int(mine.opt.count) == int(theirs.opt.count) == 2
        for a, b in zip(mine.opt.mu + mine.opt.nu,
                        theirs.opt.mu + theirs.opt.nu):
            assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), state.noise_generator.get_state())

    jt, jstate, pt, pstate = _pair(_opt("adam"), jnp.float32, torch.float32)
    ptrs = _storage(pstate)
    jstate, _ = jt.train_step(jstate, {k: jnp.asarray(v)
                                       for k, v in _batch().items()})
    load_train_state(pstate, train_state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (
            jstate.g.params, jstate.d.params,
            jstate.d.extra["batch_stats"])), int(jstate.step),
        g_opt_state=jax.tree.map(np.asarray, jstate.g.opt_state),
        d_opt_state=jax.tree.map(np.asarray, jstate.d.opt_state)))
    assert _storage(pstate) == ptrs
    assert int(pstate.g.opt.count) == 1 and pstate.step == 1
