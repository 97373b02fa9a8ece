"""The data, fsdp and tensor axes of the port (``trainner_tpu_torch/
parallel/mesh.py``, ``parallel/tensor.py`` and the trainers' steps under
a mesh) on the CPU, against the one-rank step and the JAX package:

- the mesh rules: ``make_mesh`` builds the JAX ``make_mesh``'s axes and
  raises where it does, ranks laid out as its device array;
  ``_param_spec`` gives JAX's specs, and each kind of kernel is split on
  its output channels in the port's layout;
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
- the tensor axis: ``tensor: 2``, ``data: 1, fsdp: 2, tensor: 2`` and
  ``data: 2, tensor: 2`` at ``min_shard`` 0 (every kernel the axis
  divides is computed by column), and ``tensor: 4`` at the rule's 2^16 on
  the flagship's widths in one RRDB (conv5 of each block and four D
  leaves split); three steps each against the one-rank step; the
  ``tensor: 2`` step from JAX's weights against the JAX package's own
  tensor step on two virtual devices;
- the rules that read whole weights (AdamP, SGDP, ranger with gradient
  centralisation) on ``fsdp: 2`` and ``tensor: 2``;
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
TP_STEPS = 3  # the tensor axis's and the whole-weight rules' cases
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


def _jax_params(opt):
    """The JAX trainer's initial state for ``opt`` (f32, the case's
    batch), and the trainer."""
    from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer

    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    return jt.init_state(jax.random.PRNGKey(0), (W.BATCH, 8, 8, 3)), jt


def _jax_init(tmp) -> str:
    """The JAX package's initial G and D of ``sr_plain`` as the port's
    state dicts, saved for a worker job (``init``)."""
    from trainner_tpu_torch.utils.torch_interop import (load_train_state,
                                                        train_state_from_jax)

    opt = W.options("sr_plain")
    jstate, _ = _jax_params(opt)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    pstate = create_trainer(copy.deepcopy(opt), device="cpu",
                            graphs=False).init_state(0)
    load_train_state(pstate, train_state_from_jax(
        np_tree(jstate.g.params), np_tree(jstate.d.params),
        np_tree(jstate.d.extra["batch_stats"]), int(jstate.step)))
    path = str(tmp / "jax_init.pt")
    torch.save({w: W.sd(getattr(pstate, w).net) for w in ("g", "d")}, path)
    return path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    jobs = [{"id": c, "case": c, "data": 2, "fsdp": 1, "steps": STEPS}
            for c in ("sr", "srragan", "srragan_auto", "ppon", "pix2pix")]
    jobs.append({"id": "cli", "cli": _cli_options(
        tmp, "cli", "parallel: {data: 2}\n")})
    # the tensor axis at min_shard 0: every kernel the axis divides split
    jobs += [{"id": f"{c}_tp", "case": c, "data": 1, "fsdp": 1,
              "tensor": 2, "steps": TP_STEPS, "min_shard": 0}
             for c in ("sr", "srragan")]
    # the whole-weight rules on either axis that splits a leaf
    jobs += [{"id": f"{c}_{ax}", "case": c, "data": 1,
              "fsdp": 2 if ax == "fsdp" else 1,
              "tensor": 2 if ax == "tensor" else 1, "steps": TP_STEPS,
              "min_shard": 0}
             for c in W.WHOLE_WEIGHT_CASES for ax in ("fsdp", "tensor")]
    # one tensor step from the JAX package's init (test_tensor_step_...)
    jobs.append({"id": "jax_tp", "case": "sr_plain", "data": 1, "fsdp": 1,
                 "tensor": 2, "steps": 1, "min_shard": 0,
                 "init": _jax_init(tmp)})
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
             "state_path": str(tmp / "2.state")},
            # PBR's Adam split over fsdp, its one latent draw over data
            {"id": "pbr_fsdp", "case": "pbr", "data": 2, "fsdp": 2,
             "steps": STEPS, "min_shard": 0},
            # the tensor axis beside fsdp and beside data
            {"id": "fsdp_tp", "case": "srragan", "data": 1, "fsdp": 2,
             "tensor": 2, "steps": TP_STEPS, "min_shard": 0},
            {"id": "data_tp", "case": "sr", "data": 2, "fsdp": 1,
             "tensor": 2, "steps": TP_STEPS, "min_shard": 0},
            # the rule's own 2^16 at the flagship's widths, 16 of conv5's
            # 64 columns a rank
            {"id": "wide_tp", "case": "sr_wide", "data": 1, "fsdp": 1,
             "tensor": 4, "steps": TP_STEPS}]
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
    against a world of 8) and builds the same axes where it does not; the
    ranks lie as JAX's device array, tensor innermost: rank = (d * fsdp +
    f) * tensor + t, the batch index d * fsdp + f."""
    devices = jax.devices()[:8]
    for cfg in ((4, 2, 1), (-1, 1, 1), (3, 2, 1), (8, 2, 1), (2, 4, 1),
                (1, 8, 1), (-1, 2, 1), (2, 2, 2), (1, 2, 4), (-1, 1, 2),
                (4, 1, 2), (3, 1, 2), (1, 1, 8), (2, 1, 3)):
        jc = JM.MeshConfig(data=cfg[0], fsdp=cfg[1], tensor=cfg[2])
        pc = M.MeshConfig(data=cfg[0], fsdp=cfg[1], tensor=cfg[2])
        try:
            jmesh = JM.make_mesh(jc, devices)
        except ValueError:
            with pytest.raises(ValueError):
                M.make_mesh(pc, world_size=8)
            continue
        # a valid layout: the same axes (a world of 8 needs a group to
        # build, so the sizes are read from the rule)
        data, fsdp, tensor = M._layout(pc, 8)
        want = {"data": data, "fsdp": fsdp}
        if tensor > 1:
            want["tensor"] = tensor
        assert dict(jmesh.shape) == want
        assert M.Mesh(data, fsdp, tensor=tensor).shape == want
        ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(
            data, fsdp, tensor)
        for rank in range(8):
            d, f, t = np.argwhere(ids == devices[rank].id)[0]
            layout = M.Mesh(data, fsdp, tensor=tensor)
            layout.rank, layout.world = rank, 8
            assert (layout.batch_index, layout.fsdp_index,
                    layout.tensor_index) == (d * fsdp + f, f, t)
            assert M.local_batch_slice(8 * data * fsdp, layout) == slice(
                8 * (d * fsdp + f), 8 * (d * fsdp + f + 1))
    one = M.make_mesh(M.MeshConfig(data=1))
    assert one.shape == {"data": 1, "fsdp": 1} and not one.distributed
    assert M.local_batch_slice(32, one) == slice(0, 32)


@pytest.mark.parametrize("fsdp,tp,min_size", [(2, 1, 2 ** 16), (4, 1, 0),
                                              (2, 2, 0), (3, 1, 0),
                                              (1, 2, 2 ** 16), (1, 4, 0)])
def test_param_spec_matches_jax(fsdp, tp, min_size):
    """``_param_spec`` gives JAX's spec for every leaf; for a kernel of
    each kind (``tensor.kernel_kinds``) the port's split dimension
    (``leaf_split``) is the one that holds JAX's split dimension in the
    port's layout, which for the tensor axis is the output channels:
    dimension 0 of a conv's OIHW and a conv3d's OIDHW, 1 of a deconv's
    (in, out, kh, kw), 0 of a dense layer's (out, in)."""
    from trainner_tpu_torch.parallel.tensor import JAX_LAYOUT, SPLIT_DIM

    shapes = [(3, 3, 64, 192), (3, 3, 96, 32), (192,), (), (3, 3, 192, 64),
              (5, 7), (64, 64, 3, 3), (1, 1, 24, 36), (8192, 100),
              (4, 4, 64, 64), (3, 3, 3, 16, 8)]
    for shape in shapes:
        for is_kernel in (True, False):
            want = JM._param_spec(jnp.zeros(shape), fsdp, "fsdp", tp,
                                  "tensor", min_size, is_kernel)
            got = M._param_spec(shape, fsdp, "fsdp", tp, "tensor", min_size,
                                is_kernel)
            assert tuple(want) == got, (shape, is_kernel, want, got)
    layout = M.Mesh(1, fsdp, tensor=tp, min_shard_size=min_size)
    for kind, perm in JAX_LAYOUT.items():
        for jshape in shapes:
            if len(jshape) != len(perm):
                continue
            inv = np.argsort(perm)
            port = torch.zeros(tuple(jshape[i] for i in inv))
            spec = tuple(JM._param_spec(jnp.zeros(jshape), fsdp, "fsdp", tp,
                                        "tensor", min_size, True))
            got = M.leaf_split(port, kind, layout)
            if not spec:
                assert got is None, (kind, jshape)
                continue
            axis = next(a for a in spec if a is not None)
            assert got == (axis, perm[spec.index(axis)]), (kind, jshape)
            if axis == "tensor":
                assert got[1] == SPLIT_DIM[kind], (kind, jshape)


def test_shard_dim_takes_the_jax_layout():
    """A conv weight (OIHW) is split on the dimension the rule picks in
    its HWIO layout: (3, 3, 192, 64) splits I (192), which is the port's
    dimension 1."""
    fsdp2 = M.Mesh(1, 2)
    assert M.leaf_split(torch.zeros(64, 192, 3, 3), None, fsdp2) == \
        ("fsdp", 1)
    assert M.leaf_split(torch.zeros(32, 96, 3, 3), None, fsdp2) is None
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


@pytest.mark.parametrize("job,case", [("sr", "sr"), ("fsdp", "srragan"),
                                      ("pbr_fsdp", "pbr")])
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


MESH_MODELS = {  # every model of the JAX train.py, by a case that builds it
    "sr": "sr", "srgan": "sr", "srragan": "sr", "ppon": "ppon",
    "pix2pix": "pix2pix", "cyclegan": "cyclegan", "wbc": "wbc",
    "pbr": "pbr", "sr_pbr": "pbr", "pbr_sr": "pbr", "vsr": "sr3d",
    "vsrgan": "sofvsr", "evsrgan": "evsrgan", "video": "edvr",
    "srflow": "srflow", "sftgan": "sftgan", "sftgan_acd": "sftgan",
    "dvd": "dvd"}
# the split leaves a case's nets compute whole on every tensor rank at
# min_shard 0 (ROADMAP A 9 g): SOF-VSR's depthwise convs, EDVR's
# deformable convs
WHOLE_LEAVES = {
    "sofvsr": {f"g.OFR.{body}.resb{i}.dw.weight"
               for body in ("rnn1_body", "sr_body") for i in range(3)},
    "edvr": {f"g.pcd_align.{n}.weight"
             for n in ("cas_dcn", "dcn_l1", "dcn_l2", "dcn_l3")}}


@pytest.mark.parametrize("model", sorted(MESH_MODELS))
def test_other_models_raise(model):
    """No model raises on any axis (A 9 d and A 9 e are ported): each
    model of the JAX ``train.py`` builds under a one-rank mesh, keeps it,
    and its state is placed on it; on a ``tensor: 2`` layout (min_shard
    0, read without a group) every leaf that JAX's rule splits over
    ``tensor`` is marked to be computed by column (its weight and bias
    ``tensor_summed``) or is listed as computed whole, and the whole ones
    are A 9 g's. The worker jobs of ``test_torch_parallel_models.py``
    train each model's case on ``tensor: 2``."""
    from trainner_tpu_torch.parallel.tensor import kernel_kinds

    case = MESH_MODELS[model]
    opt = W.options(case)
    opt["model"] = model
    one = M.make_mesh(M.MeshConfig(data=1))
    trainer = create_trainer(opt, device="cpu", graphs=False, mesh=one)
    assert trainer.mesh is one
    assert trainer.init_state(0).step == 0
    layout = M.Mesh(1, 1, tensor=2, min_shard_size=0)
    state = create_trainer(opt, device="cpu", graphs=False).init_state(0)
    whole = M.place_tensor(state, layout)
    assert set(whole) == WHOLE_LEAVES.get(case, set())
    marked = []
    for w in M.net_fields(state):
        ns = getattr(state, w, None)
        if ns is None:
            continue
        specs = M.param_sharding(ns.net, layout, min_size=0)
        kinds = kernel_kinds(ns.net)
        for name, p in ns.net.named_parameters():
            split = "tensor" in specs[name]
            assert split <= (name in kinds), (model, name)
            routed = getattr(p, "tensor_summed", False)
            if name in kinds:
                assert split == (routed or f"{w}.{name}" in whole), \
                    (model, name)
            if routed:
                marked.append(name)
    assert marked, model


def _split_weights(res: dict) -> list:
    return [n for n in res["split"] if n.endswith("weight")]


@pytest.mark.parametrize("case", ["sr", "srragan"])
def test_tensor_two_ranks_equal_one(two_ranks, one_rank, case):
    """``tensor: 2`` at min_shard 0: each rank computes its columns of
    every kernel the axis divides (at least five in G and D together),
    and three steps equal the one-rank steps."""
    got = two_ranks[0][f"{case}_tp"]
    assert len(_split_weights(got)) >= 5 and not got["whole"]
    _same_step(got, one_rank(case, TP_STEPS), f"tensor 2 {case}")


@pytest.mark.parametrize("axis", ["fsdp", "tensor"])
@pytest.mark.parametrize("case", sorted(W.WHOLE_WEIGHT_CASES))
def test_whole_weight_rules_equal_one(two_ranks, one_rank, case, axis):
    """AdamP's and SGDP's projections and ranger's gradient
    centralisation read whole weights (A 9 f): on ``fsdp: 2`` and on
    ``tensor: 2`` at min_shard 0 each leaf is updated whole, and three
    steps equal the one-rank steps."""
    _same_step(two_ranks[0][f"{case}_{axis}"], one_rank(case, TP_STEPS),
               f"{axis} 2 {case}")


@pytest.mark.parametrize("job,case", [("fsdp_tp", "srragan"),
                                      ("data_tp", "sr"),
                                      ("wide_tp", "sr_wide")])
def test_tensor_four_ranks_equal_one(four_ranks, one_rank, job, case):
    """``data: 1, fsdp: 2, tensor: 2`` and ``data: 2, tensor: 2`` at
    min_shard 0, and ``tensor: 4`` at the rule's 2^16 on the flagship's
    widths, where exactly conv5 of each of the RRDB's three blocks and
    D-VGG's conv0_1, conv1_0, conv1_1 and linear0 split (16 of conv5's
    64 columns a rank): three steps equal the one-rank steps."""
    got = four_ranks[0][job]
    if job == "wide_tp":
        want = [f"g.RRDB_trunk.0.RDB{i}.conv5.weight" for i in (1, 2, 3)]
        want += [f"d.{n}.weight"
                 for n in ("conv0_1", "conv1_0", "conv1_1", "linear0")]
        assert sorted(_split_weights(got)) == sorted(want)
    else:
        assert len(_split_weights(got)) >= 5
    _same_step(got, one_rank(case, TP_STEPS), f"4 ranks {job}")


def test_tensor_step_matches_jax(two_ranks):
    """The port's ``tensor: 2`` step (two gloo ranks, every kernel the
    axis divides computed by column) against the JAX package's own step
    on a ``tensor: 2`` mesh of two virtual devices, GSPMD partitioning it
    from ``param_sharding`` at min_size 0, from the same weights and
    batch: every log at 1e-4 relative, G's parameters within 2 lr (Adam's
    first step is lr times a sign), as ``test_one_rank_step_matches_jax``
    holds the one-rank step."""
    from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
    from trainner_tpu_torch.utils.torch_interop import g_from_jax

    opt = W.options("sr_plain")
    mesh = JM.make_mesh(JM.MeshConfig(data=1, fsdp=1, tensor=2),
                        jax.devices()[:2])
    jt = JaxTrainer(copy.deepcopy(opt), mesh=mesh, dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (W.BATCH, 8, 8, 3))
    jstate = jax.tree.map(jax.device_put, jstate,
                          JM.param_sharding(jstate, mesh, min_size=0))
    n_tp = sum(1 for leaf in jax.tree.leaves(jstate.g.params)
               if leaf.ndim >= 2 and "tensor" in leaf.sharding.spec)
    assert n_tp >= 5
    b = W.batch("sr_plain", 0)
    jstate, jlogs = jt.train_step(jstate, JM.shard_batch(
        {k: jnp.asarray(v) for k, v in b.items()}, mesh))
    got = two_ranks[0]["jax_tp"]
    assert len(_split_weights(got)) >= 5
    logs = got["logs"][0]
    assert set(logs) == set(jlogs)
    for k in jlogs:
        want = float(jlogs[k])
        floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
        assert abs(logs[k] - want) <= 1e-4 * max(abs(want), floor), k
    net = create_trainer(copy.deepcopy(opt), device="cpu",
                         graphs=False).init_state(0).g.net
    jg = g_from_jax(jax.tree.map(np.asarray, jstate.g.params), None, net)
    lr = float(opt["train"]["lr_G"])
    for k, p in got["g"].items():
        if k in jg:
            assert float((p - jg[k]).abs().max()) <= 2 * lr, k
