"""The SRFlow trainer (``trainner_tpu_torch/train/srflow_trainer.py``)
against the JAX ``SRFlowTrainer`` on the CPU, for both nets (``srflow_net``
and ``flow.interop``) at a small size (nf 8, nb 2, gc 4, K 2, L 3, hidden
8; b=2, 8 -> 32 px), from one state carried from JAX: three steps of the
template's trainer (Adam, MultiStepLR, the norm clip at 1.0,
``fl_weight`` 0, which means 1) whose encoder unfreezes at step 2
(``train_RRDB_delay`` 0.5 of ``niter`` 4), each step fed JAX's own
quantisation noise (``draw_hook``). Every log within 1e-4 relative, every
tensor within 1e-3 of its update (``check_tensors``); the port's frozen
encoder equal to its start bit for bit over the frozen steps, its blocks'
backward run only once unfrozen (calls of the kernels' plain versions,
which stand in for the kernels here); ``eval_step`` at
heat 0 against the JAX one, every draw at one heat the same image; the
state saved and resumed, and a JAX-written ``.state`` loaded.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pix2pix_trainer import check_tensors, sd
from test_torch_train_step import _check_logs, _numpy
from trainner_tpu.train import srflow_trainer as JT
from trainner_tpu.train.state import NetState as JNetState
from trainner_tpu.train.state import SRTrainState as JState
from trainner_tpu.utils import checkpoint as jckpt
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train import srflow_trainer as PT
from trainner_tpu_torch.utils import checkpoint as pckpt
from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                    net_to_jax,
                                                    train_state_from_jax)

torch.set_num_threads(2)
B, LR, S, STEPS = 2, 8, 4, 3
G_CFG = {"type": "srflow_net", "nf": 8, "nb": 2, "gc": 4, "K": 2,
         "flow": {"L": 3, "hidden_channels": 8,
                  "stackRRDB": {"blocks": [0, 1]}}}


def options(interop: bool):
    g = copy.deepcopy(G_CFG)
    g["flow"]["interop"] = interop
    opt = {"name": "srflow_steps", "model": "srflow", "scale": S,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x", "crop_size": LR * S,
                                  "batch_size": B}},
           "network_G": g, "path": {"root": "/tmp/srflow_steps"},
           "train": {"lr_G": 1e-3, "lr_scheme": "MultiStepLR",
                     "lr_steps_rel": [0.5], "lr_gamma": 0.5, "niter": 4,
                     "fl_weight": 0, "train_RRDB_delay": 0.5,
                     "grad_clip": "norm", "grad_clip_value": 1.0}}
    return dict(parse_dict(opt, is_train=True))


def batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    hr = rng.rand(B, LR * S, LR * S, 3).astype(np.float32)
    lr = hr.reshape(B, LR, S, LR, S, 3).mean((2, 4))
    return {"LR": lr.astype(np.float32), "HR": hr}


def carried(jstate, pstate):
    return train_state_from_jax(
        _numpy(jstate.g.params), None, None, int(jstate.step),
        g_opt_state=_numpy(jstate.g.opt_state), g_net=pstate.g.net)


def _start(opt):
    """Both trainers, the JAX state built from the port's init with its
    weights moved by a seeded draw (no flax init to compile)."""
    jt = JT.SRFlowTrainer(copy.deepcopy(opt))
    pt = PT.SRFlowTrainer(copy.deepcopy(opt), device="cpu")
    pstate = pt.init_state(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in pstate.g.net.parameters():
            p.mul_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    params, _ = net_to_jax(pstate.g.net.state_dict(), pstate.g.net)
    params = jax.tree.map(jnp.asarray, params)
    jstate = JState(step=jnp.zeros([], jnp.int32),
                    rng=jax.random.PRNGKey(3),
                    g=JNetState(params=params,
                                opt_state=jt.optG.init(params), extra={}))
    load_train_state(pstate, carried(jstate, pstate))
    return jt, jstate, pt, pstate


class _Counted:
    """Counts the calls of the block kernels' plain versions."""

    def __init__(self):
        self.fwd = self.bwd = 0
        self.orig = (rdb5c.rdb5c_forward_plain, rdb5c.rdb5c_backward_plain)

    def __enter__(self):
        def fwd(*a, **k):
            self.fwd += 1
            return self.orig[0](*a, **k)

        def bwd(*a, **k):
            self.bwd += 1
            return self.orig[1](*a, **k)

        rdb5c.rdb5c_forward_plain, rdb5c.rdb5c_backward_plain = fwd, bwd
        return self

    def __exit__(self, *exc):
        rdb5c.rdb5c_forward_plain, rdb5c.rdb5c_backward_plain = self.orig


@pytest.fixture(scope="module", params=["srflow_net", "interop"])
def run(request):
    opt = options(request.param == "interop")
    jt, jstate, pt, pstate = _start(opt)
    enc0 = {k: v.clone() for k, v in pstate.g.net.RRDB.state_dict().items()}
    steps = []
    for step in range(STEPS):
        b = batch(step)
        load_train_state(pstate, carried(jstate, pstate))
        before = sd(pstate.g.net)
        key = jax.random.split(jstate.rng)[1]
        pt.draw_hook = lambda shapes, key=key: {"noise": torch.from_numpy(
            np.array(jax.random.uniform(key, shapes["noise"])))}
        jstate, jlogs = jt.train_step(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
        with _Counted() as counted:
            pstate, logs = pt.train_step(
                pstate, {k: torch.from_numpy(v) for k, v in b.items()})
        runs = (counted.fwd, counted.bwd)
        enc = {k: torch.equal(v, enc0[k])
               for k, v in pstate.g.net.RRDB.state_dict().items()}
        want = carried(jstate, pstate)["g"]
        steps.append({"logs": {k: float(v) for k, v in logs.items()},
                      "jlogs": {k: float(v) for k, v in jlogs.items()},
                      "before": before, "after": sd(pstate.g.net),
                      "want": {k: v.numpy() for k, v in want.items()},
                      "runs": runs, "enc_kept": all(enc.values())})
    return {"steps": steps, "jt": jt, "jstate": jstate, "pt": pt,
            "pstate": pstate, "opt": opt, "case": request.param}


@pytest.mark.parametrize("step", range(STEPS))
def test_steps_match_jax(run, step):
    s = run["steps"][step]
    _check_logs(s["logs"], s["jlogs"], 1e-4, step)
    check_tensors(s["after"], s["want"], s["before"], step, run["case"])


def test_freeze_then_unfreeze(run):
    """Frozen steps leave the encoder as it started, bit for bit, and run
    its blocks forward only; the unfrozen step runs their backward too."""
    nb = len(run["pstate"].g.net.blocks())
    assert run["pt"].rrdb_unfreeze_iter == 2 and run["pt"].fl_weight == 1.0
    for step, s in enumerate(run["steps"]):
        frozen = step < 2
        assert s["runs"] == (nb, 0 if frozen else nb), (step, s["runs"])
        if frozen:
            assert s["enc_kept"], step
    assert not run["steps"][2]["enc_kept"]


def test_eval_step_matches_jax(run):
    """Heat 0 against the JAX ``eval_step``; at heat 0.8 every call gives
    the same image."""
    b = batch(5)
    want = run["jt"].eval_step(run["jstate"], jnp.asarray(b["LR"]), 0.0)
    got = run["pt"].eval_step(run["pstate"], torch.from_numpy(b["LR"]), 0.0)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    hot = [run["pt"].eval_step(run["pstate"], torch.from_numpy(b["LR"]),
                               0.8) for _ in range(2)]
    assert torch.equal(hot[0], hot[1]) and not torch.equal(hot[0], got)


def test_save_resume_and_jax_state(run, tmp_path):
    """The port's ``.state`` resumes into a fresh state bit for bit; the
    JAX package's ``.state`` of the last step loads into the port."""
    pt, pstate = run["pt"], run["pstate"]
    path = str(tmp_path / "3.state")
    pckpt.save_state(pstate, path)
    fresh = PT.SRFlowTrainer(copy.deepcopy(run["opt"]), device="cpu")
    other = fresh.init_state(5)
    other, meta = pckpt.load_state(path, other)
    assert meta["iter"] == STEPS and other.step == STEPS
    for k, v in pstate.g.net.state_dict().items():
        assert torch.equal(v, other.g.net.state_dict()[k]), k
    mine, theirs = pstate.g.opt.state_dict(), other.g.opt.state_dict()
    assert mine["count"] == theirs["count"] == STEPS
    for key in pstate.g.opt.lists:
        for a, b in zip(mine[key], theirs[key]):
            assert torch.equal(a, b), key
    jpath = str(tmp_path / "jax.state")
    jckpt.save_state(run["jstate"], jpath)
    third = fresh.init_state(6)
    third, _ = pckpt.load_state(jpath, third)
    want = carried(run["jstate"], third)["g"]
    for k, v in third.g.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    assert os.path.getsize(jpath) > 0 and third.step == STEPS
