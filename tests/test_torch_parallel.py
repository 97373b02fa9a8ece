"""The data and fsdp axes of the port (``trainner_tpu_torch/parallel/
mesh.py`` and the trainers' steps under a mesh) on the CPU, against the
one-rank step and the JAX package:

- the mesh rules: ``make_mesh`` raises where the JAX ``make_mesh`` does,
  a tensor axis raises naming A 9 e, ``_param_spec`` gives JAX's specs;
- 2- and 4-rank gloo groups (ranks in processes of their own, that import
  no JAX: ``tests/torch_parallel_worker.py``) run the cases' steps on
  their slices of the global batch; each equals the one-rank step on the
  whole batch at the JAX package's mesh tolerance (rtol 2e-4, atol 2e-5,
  ``tests/test_parallel.py:146-152``): every log, G's and D's parameters
  and gradients. The cases cover what couples samples: D's batch norms
  and their running statistics, the relativistic GAN's batch means, a
  batch augmentation that mixes samples with DiffAugment's per-sample
  draws and a virtual batch, the norm and auto clips, G's latent noise
  and dropout, PPON's and pix2pix's steps, and ``data: 2, fsdp: 2``;
- a ``data: 2, fsdp: 2`` checkpoint: a resumed run equals the
  uninterrupted one bit for bit, and the file loads in the JAX package
  and in a one-rank port run;
- the one-rank step against the JAX ``train_step``;
- the ranks' batches of the loader put together are the one-process
  batch.

Each spawned group stays under 20 s here: ranks set one thread and meet
through a file store under the test's temporary directory.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from trainner_tpu.parallel import mesh as JM
from trainner_tpu_torch.parallel import mesh as M
from trainner_tpu_torch.train.sr_trainer import create_trainer

torch.set_num_threads(2)
RTOL, ATOL = 2e-4, 2e-5
STEPS = 2
# a D bias whose gradient is 0 but for rounding (a conv that a batch norm
# follows: the norm removes any shift) moves by noise; held to this bound
NOISE = 1e-4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


def _spawn(world: int, jobs: list, tmp) -> dict:
    """Runs ``jobs`` on a gloo group of ``world`` worker processes; rank
    0's results."""
    store, out = str(tmp / "store"), str(tmp / "out.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    procs = []
    for rank in range(world):
        spec = tmp / f"spec{rank}.json"
        spec.write_text(json.dumps({"rank": rank, "world": world,
                                    "store": store, "out": out,
                                    "jobs": jobs}))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return torch.load(out, weights_only=False)


DEBUG_YML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "options", "sr", "train_sr_debug.yml")


def _cli_options(tmp, root: str, extra: str = "", niter: int = 4,
                 resume: str = "") -> str:
    """The debug config (``options/sr/train_sr_debug.yml``) with its root
    under ``tmp``, ``niter`` iterations, ``extra`` lines at the top and
    ``resume`` as ``path.resume_state``."""
    with open(DEBUG_YML) as f:
        text = f.read()
    text = text.replace("root: /tmp/trainner_tpu_debug",
                        f"root: {tmp / root}")
    if resume:
        text = text.replace("path:\n", f"path:\n  resume_state: {resume}\n")
    text = text.replace("niter: 12", f"niter: {niter}")
    path = tmp / f"{root}.yml"
    path.write_text(extra + text)
    return str(path)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    jobs = [{"id": c, "case": c, "data": 2, "fsdp": 1, "steps": STEPS}
            for c in ("sr", "srragan", "srragan_auto", "ppon", "pix2pix")]
    jobs.append({"id": "cli", "cli": _cli_options(
        tmp, "cli", "parallel: {data: 2}\n")})
    return _spawn(2, jobs, tmp), tmp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    jobs = [{"id": "sr", "case": "sr", "data": 4, "fsdp": 1,
             "steps": STEPS},
            # min_shard 0: the debug nets are small, so every leaf the axis
            # divides is split, as the JAX test forces with min_size=0
            {"id": "fsdp", "case": "srragan", "data": 2, "fsdp": 2,
             "steps": STEPS, "min_shard": 0},
            {"id": "resume", "case": "sr", "data": 2, "fsdp": 2,
             "steps": 4, "save_at": 2, "min_shard": 0,
             "state_path": str(tmp / "2.state")}]
    return _spawn(4, jobs, tmp), str(tmp / "2.state")


@pytest.fixture(scope="module")
def one_rank():
    cache = {}

    def get(case, steps=STEPS):
        if (case, steps) not in cache:
            cache[case, steps] = W.run_case(case, steps)
        return cache[case, steps]
    return get


def _noise_only(name: str, tensors: dict) -> bool:
    return name.endswith("bias") and \
        name.replace("bias", "norm.weight") in tensors


def _same_step(got: dict, ref: dict, what: str) -> None:
    """Logs, G's and D's tensors and gradients at the mesh tolerance."""
    assert len(got["logs"]) == len(ref["logs"])
    for step, (lg, lr) in enumerate(zip(got["logs"], ref["logs"])):
        assert set(lg) == set(lr), (what, step)
        for k in lr:
            np.testing.assert_allclose(lg[k], lr[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} step {step} {k}")
    for net in ("g", "d", "g_grad", "d_grad"):
        if net not in ref:
            continue
        assert set(got[net]) == set(ref[net]), (what, net)
        for k, want in ref[net].items():
            have = got[net][k]
            if not want.is_floating_point():
                assert torch.equal(have, want), (what, net, k)
            elif net[0] == "d" and _noise_only(k, ref["d"]):
                assert float((have - want).abs().max()) <= NOISE, \
                    (what, net, k)
            else:
                np.testing.assert_allclose(
                    have.numpy(), want.numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what} {net} {k}")


def test_mesh_rules_match_jax():
    """The port's make_mesh raises where JAX's does (8 virtual devices
    against a world of 8), builds the same axes where it does not, and
    refuses a tensor axis naming A 9 e."""
    devices = jax.devices()[:8]
    for cfg in ((4, 2), (-1, 1), (3, 2), (8, 2), (2, 4), (1, 8), (-1, 2)):
        jc = JM.MeshConfig(data=cfg[0], fsdp=cfg[1])
        pc = M.MeshConfig(data=cfg[0], fsdp=cfg[1])
        try:
            jmesh = JM.make_mesh(jc, devices)
        except ValueError:
            with pytest.raises(ValueError):
                M.make_mesh(pc, world_size=8)
            continue
        # a valid layout: the same axes (a world of 8 needs a group to
        # build, so the sizes are read from the rule)
        data = pc.data if pc.data > 0 else 8 // pc.fsdp
        assert dict(jmesh.shape) == {"data": data, "fsdp": pc.fsdp}
    with pytest.raises(NotImplementedError, match="A 9 e"):
        M.make_mesh(M.MeshConfig(data=1, fsdp=1, tensor=2), world_size=2)
    one = M.make_mesh(M.MeshConfig(data=1))
    assert one.shape == {"data": 1, "fsdp": 1} and not one.distributed
    assert M.local_batch_slice(32, one) == slice(0, 32)


@pytest.mark.parametrize("fsdp,tp,min_size", [(2, 1, 2 ** 16), (4, 1, 0),
                                              (2, 2, 0), (3, 1, 0)])
def test_param_spec_matches_jax(fsdp, tp, min_size):
    shapes = [(3, 3, 64, 192), (3, 3, 96, 32), (192,), (), (3, 3, 192, 64),
              (5, 7), (64, 64, 3, 3), (1, 1, 24, 36)]
    for shape in shapes:
        for is_kernel in (True, False):
            want = JM._param_spec(jnp.zeros(shape), fsdp, "fsdp", tp,
                                  "tensor", min_size, is_kernel)
            got = M._param_spec(shape, fsdp, "fsdp", tp, "tensor", min_size,
                                is_kernel)
            assert tuple(want) == got, (shape, is_kernel, want, got)


def test_shard_dim_takes_the_jax_layout():
    """A conv weight (OIHW) is split on the dimension the rule picks in
    its HWIO layout: (3, 3, 192, 64) splits I (192), which is the port's
    dimension 1."""
    from trainner_tpu_torch.train.optimizers import jax_view

    w = torch.zeros(64, 192, 3, 3)
    assert M.shard_dim(w, jax_view(w), 2) == 1
    assert M.shard_dim(torch.zeros(32, 96, 3, 3),
                       jax_view(torch.zeros(32, 96, 3, 3)), 2) is None
    # a net's specs by name, in the JAX layout (a layout of fsdp 2 read
    # without a group)
    net = torch.nn.Sequential(torch.nn.Conv2d(192, 64, 3),
                              torch.nn.Conv2d(96, 32, 3))
    specs = M.param_sharding(net, M.Mesh(1, 2))
    assert specs == {"0.weight": (None, None, "fsdp", None), "0.bias": (),
                     "1.weight": (), "1.bias": ()}


@pytest.mark.parametrize("case", ["sr", "srragan", "srragan_auto", "ppon",
                                  "pix2pix"])
def test_two_ranks_equal_one(two_ranks, one_rank, case):
    _same_step(two_ranks[0][case], one_rank(case), f"2 ranks {case}")


def test_two_rank_cli_and_its_one_rank_resume(two_ranks):
    """``torchrun --nproc_per_node 2`` as the CLI sees it: the debug
    config with ``parallel: {data: 2}`` trains 4 iterations on a gloo
    group of two, rank 0 writing the experiment (models, state, log);
    the CLI without ``parallel:`` resumes that state to 6."""
    from trainner_tpu_torch.train import main as train_main

    res, tmp = two_ranks
    assert res["cli"]["step"] == 4
    exp = tmp / "cli" / "experiments" / "debug_sr_synth"
    for f in ("models/4_G.ckpt", "models/4_D.ckpt",
              "training_state/4.state"):
        assert (exp / f).exists(), f
    logs = "".join(p.read_text() for p in exp.glob("train_*.log"))
    assert "Device mesh: {'data': 2, 'fsdp': 1} over 2 ranks (gloo)" in logs
    state = train_main(["-opt", _cli_options(
        tmp, "cli", niter=6, resume=str(exp / "training_state"))],
        device="cpu")
    assert state.step == 6


@pytest.mark.parametrize("job,case", [("sr", "sr"), ("fsdp", "srragan")])
def test_four_ranks_equal_one(four_ranks, one_rank, job, case):
    _same_step(four_ranks[0][job], one_rank(case), f"4 ranks {job}")


def test_fsdp_checkpoint_resumes_exactly(four_ranks, one_rank):
    """data 2 x fsdp 2, the optimizer state split: 2 steps, a save, 2
    more; a fresh state loaded from the save and run over the same 2
    steps ends bit for bit where the uninterrupted run did; both equal
    the one-rank run of 4 steps at the mesh tolerance."""
    res = four_ranks[0]["resume"]
    full, resumed = res["full"], res["resumed"]
    assert resumed["step"] == 4
    for net in ("g", "d"):
        for k, v in full[net].items():
            assert torch.equal(resumed[net][k], v), (net, k)
    _same_step(full, one_rank("sr", 4), "4 ranks resume")


def test_fsdp_checkpoint_loads_in_jax_and_one_rank(four_ranks):
    """The N-rank state file, written by rank 0 in the one-process
    format (the optimizer's parts put together first), loads in the JAX
    package's ``load_state`` and in a one-rank port state, and both hold
    the values the port saved."""
    from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
    from trainner_tpu.utils.checkpoint import load_state as jax_load
    from trainner_tpu_torch.utils import checkpoint
    from trainner_tpu_torch.utils.torch_interop import g_to_jax

    path = four_ranks[1]
    opt = W.options("sr")
    trainer = create_trainer(copy.deepcopy(opt), device="cpu", graphs=False)
    state, meta = checkpoint.load_state(path, trainer.init_state(0))
    assert meta["iter"] == 2 and state.step == 2
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (W.BATCH, 8, 8, 3))
    jstate, jmeta = jax_load(path, template)
    assert jmeta["iter"] == 2 and int(jstate.step) == 2
    want = g_to_jax({k: v for k, v in state.g.net.state_dict().items()},
                    state.g.net)[0]
    got = jax.tree.map(np.asarray, jstate.g.params)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    # the moments the four ranks split, whole again in the file
    mu = jax.tree.leaves(jstate.g.opt_state)
    assert any(np.abs(np.asarray(m)).max() > 0 for m in mu
               if np.asarray(m).ndim)
    port_mu = state.g.opt.state_dict()["mu"]
    assert all(torch.isfinite(t).all() for t in port_mu)


def test_one_rank_step_matches_jax():
    """The one-rank step (the N ranks' reference) against the JAX
    ``train_step`` of ``tests/test_parallel.py``'s trainer, from the same
    weights and batch: every log at 1e-4 relative, G's parameters within
    2 lr (Adam's first step is lr times a sign), as
    ``tests/test_torch_train_step.py`` holds the step."""
    from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
    from trainner_tpu_torch.utils.torch_interop import (g_from_jax,
                                                        load_train_state,
                                                        train_state_from_jax)

    opt = W.options("sr")
    opt["network_G"]["gaussian_noise"] = False
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (W.BATCH, 8, 8, 3))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    pt = create_trainer(copy.deepcopy(opt), device="cpu", graphs=False)
    pstate = pt.init_state(0)
    load_train_state(pstate, train_state_from_jax(
        np_tree(jstate.g.params), np_tree(jstate.d.params),
        np_tree(jstate.d.extra["batch_stats"]), int(jstate.step)))
    b = W.batch("sr", 0)
    jstate, jlogs = jt.train_step(jstate, {k: jnp.asarray(v)
                                           for k, v in b.items()})
    pstate, logs = pt.train_step(pstate, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    assert set(logs) == set(jlogs)
    for k in jlogs:
        want = float(jlogs[k])
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        assert abs(float(logs[k]) - want) <= 1e-4 * max(abs(want), floor), k
    jg = g_from_jax(np_tree(jstate.g.params), None, pstate.g.net)
    lr = float(opt["train"]["lr_G"])
    for k, p in pstate.g.net.named_parameters():
        assert float((p.detach() - jg[k]).abs().max()) <= 2 * lr, k


def test_rank_parts_of_the_loader_make_the_batch():
    """Each rank's ``DataLoader`` (``part``: its ``local_batch_slice``)
    reads its samples of every shuffled batch; the parts in rank order are
    the one-process batches, epoch after epoch."""
    from trainner_tpu_torch.data.loader import DataLoader

    class Items:
        def __len__(self):
            return 40

        def __getitem__(self, i):
            return {"HR": np.full((2, 2, 1), i, np.float32)}

    class Rank:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

    def epochs(loader, n=2):
        return [[b["HR"][:, 0, 0, 0].tolist() for b in loader]
                for _ in range(n)]

    whole = epochs(DataLoader(Items(), 8, shuffle=True, drop_last=True,
                              seed=3, num_workers=0))
    for world in (2, 4):
        parts = [epochs(DataLoader(
            Items(), 8, shuffle=True, drop_last=True, seed=3, num_workers=2,
            part=M.local_batch_slice(8, Rank(r, world))))
            for r in range(world)]
        for e in range(2):
            for i, batch in enumerate(whole[e]):
                assert sum((p[e][i] for p in parts), []) == batch


def test_other_models_raise():
    """A model whose step is not on the data axis raises naming A 9 d."""
    opt = W.options("sr")
    opt["model"] = "cyclegan"
    one = M.make_mesh(M.MeshConfig(data=1))
    with pytest.raises(NotImplementedError, match="A 9 d"):
        create_trainer(opt, device="cpu", graphs=False, mesh=one)
