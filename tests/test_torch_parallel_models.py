"""Every other model of the port on the data axis (ROADMAP Queue A 9 d)
on the CPU: CycleGAN, WBC, PBR, the video Gs (SOF-VSR with its GAN and
OFR term, SR3D, EDVR, EVSRGAN; RIFE's batch norms in train mode), both
SRFlow nets across the encoder's unfreeze, SFTGAN and DVD (lsgan with a
batch-norm D, and wgan-gp).

One spawned gloo group of two ranks (``tests/torch_parallel_worker.py``
processes, which import no JAX) runs each case's steps on the ranks'
slices of the global batch; each must equal the one-rank step on the
whole batch at the JAX package's mesh tolerance (rtol 2e-4, atol 2e-5,
``tests/test_parallel.py:146-152``): every log, every net's parameters,
buffers and last gradients. Where a tensor misses it, ROADMAP C 22's rule
holds it: an input that rounds across a ReLU-class kink moves the
elements it feeds by their whole share, so such a tensor is held in L2
norm, within 1e-2 of its update over the run (of its own norm for a
gradient). The pools of CycleGAN and WBC, queried on every rank with the
gathered batch, make the JAX ``ImagePool``'s choices on that batch; a
two-rank CycleGAN checkpoint loads in the JAX package and into a one-rank
port state bit for bit, which then trains on. The group takes about 15 s
here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from test_torch_parallel import ATOL, RTOL, STEPS, _spawn
from trainner_tpu.utils.image_pool import ImagePool as JaxPool
from trainner_tpu_torch.train.sr_trainer import create_trainer

torch.set_num_threads(2)
# rounding noise: a D bias that a batch norm follows has a gradient of 0
# but for rounding, and moves by it (tests/test_torch_parallel.py)
NOISE = 1e-4
# the cases whose tensors may need C 22's L2 rule: instance and batch
# norms put values of unit spread at every ReLU-class kink (ROADMAP
# C 15): CycleGAN's and WBC's nets, SFTGAN's ACD D (LeakyReLU after each
# batch norm)
KINKED = ("cyclegan", "wbc", "sftgan")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_rank_models")
    path = str(tmp / "cyclegan.state")
    jobs = [{"id": c, "case": c, "data": 2, "fsdp": 1, "steps": STEPS}
            for c in W.MODEL_CASES if c != "cyclegan"]
    # CycleGAN saves after its last step; a fresh two-rank state loads it
    jobs.append({"id": "cyclegan", "case": "cyclegan", "data": 2,
                 "fsdp": 1, "steps": STEPS, "save_at": STEPS,
                 "state_path": path})
    jobs.append({"id": "rife", "rife": True, "data": 2, "fsdp": 1})
    res = _spawn(2, jobs, tmp)
    res["cyclegan"], res["cyclegan_loaded"] = (res["cyclegan"]["full"],
                                               res["cyclegan"]["resumed"])
    return res, path


@pytest.fixture(scope="module")
def one_rank():
    cache = {}

    def get(case):
        if case not in cache:
            trainer = create_trainer(W.options(case), device="cpu",
                                     graphs=False)
            start = W.nets(trainer.init_state(0))
            cache[case] = (W.run_case(case, STEPS), start)
        return cache[case]
    return get


def _close(have: torch.Tensor, want: torch.Tensor, old, what: str,
           kinked: bool) -> None:
    if not want.is_floating_point():
        assert torch.equal(have, want), what
        return
    if np.allclose(have.numpy(), want.numpy(), rtol=RTOL, atol=ATOL):
        return
    diff = float(torch.linalg.vector_norm((have - want).double()))
    if old is None:  # a gradient: against its own norm
        scale = float(torch.linalg.vector_norm(want.double()))
    else:
        scale = float(torch.linalg.vector_norm((want - old).double()))
    assert kinked and scale > 1e-6 and diff <= 1e-2 * scale, \
        (what, float((have - want).abs().max()), diff, scale)


def same_models(got: dict, ref: dict, start: dict, case: str) -> None:
    """Every log at the mesh tolerance; every net's tensors and last
    gradients at it, or under C 22's L2 rule where the case has kinks."""
    kinked = case in KINKED
    assert len(got["logs"]) == len(ref["logs"]) == STEPS
    for step, (lg, lr) in enumerate(zip(got["logs"], ref["logs"])):
        assert set(lg) == set(lr), (case, step)
        for k in lr:
            np.testing.assert_allclose(lg[k], lr[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} step {step} {k}")
    fields = [w for w in W.NET_FIELDS if w in ref]
    assert fields and set(fields) == {w for w in W.NET_FIELDS if w in got}
    for w in fields:
        for grad in (False, True):
            key = f"{w}_grad" if grad else w
            assert set(got[key]) == set(ref[key]), (case, key)
            for k, want in ref[key].items():
                have = got[key][k]
                if w != "g" and k.endswith("bias") and \
                        k.replace("bias", "norm.weight") in ref[w]:
                    assert float((have - want).abs().max()) <= NOISE, \
                        (case, key, k)
                    continue
                _close(have, want, None if grad else start[w][k],
                       f"{case} {key} {k}", kinked)


@pytest.mark.parametrize("case", W.MODEL_CASES)
def test_two_ranks_equal_one(two_ranks, one_rank, case):
    ref, start = one_rank(case)
    same_models(two_ranks[0][case], ref, start, case)


def test_rife_batch_norms_see_the_global_batch(two_ranks):
    """RIFE in train mode (f64) on two ranks' halves: its outputs and
    committed running statistics equal one pass over the whole batch at
    the mesh tolerance, and so do its gradients, or within 3 times (in L2
    norm) what the one pass's own gradient moves when the batch's halves
    are swapped: its batch norms keep f32 statistics, whose rounding the
    coarsest flow block amplifies. The one pass runs on one thread, as
    each rank does: the CPU's threads split its backward's sums another
    way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, swapped = W.run_rife(), W.run_rife(swap=True)
    finally:
        torch.set_num_threads(threads)
    got = two_ranks[0]["rife"]
    for a, b in zip(got["outs"], want["outs"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    for key in ("g", "g_grad"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            have = got[key][k]
            if key == "g" or np.allclose(have.numpy(), v.numpy(),
                                         rtol=RTOL, atol=ATOL):
                np.testing.assert_allclose(have.numpy(), v.numpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{key} {k}")
                continue
            diff = float(torch.linalg.vector_norm(have - v))
            noise = float(torch.linalg.vector_norm(swapped[key][k] - v))
            assert diff <= 3 * noise, (k, diff, noise)
    assert any(k.endswith("running_mean") for k in want["g"])


@pytest.mark.parametrize("case", ["cyclegan", "wbc"])
def test_the_pools_make_the_jax_choices_on_the_global_batch(two_ranks,
                                                            case):
    """Each query of each pool, on every rank with the gathered fakes:
    what the Ds were given (the ranks' rows put together) is what the JAX
    ``ImagePool`` (seeded 0, of the same size) gives for that global
    batch, query after query; the pools swap within the run."""
    calls = two_ranks[0][case]["pools"]
    size = int(W.options(case)["pool_size"])
    pools = {}
    swapped = 0
    assert len(calls) == 2 * STEPS
    for idx, fakes, out in calls:
        assert fakes.shape[0] == W.BATCH
        want = pools.setdefault(idx, JaxPool(size)).query(fakes.numpy())
        assert np.array_equal(out.numpy(), want), (case, idx)
        swapped += int((out != fakes).flatten(1).any(1).sum())
    assert swapped > 0


def test_two_rank_cyclegan_checkpoint_loads_in_jax_and_one_rank(two_ranks):
    """The two-rank state file (rank 0 writes it in the one-process
    format) loads in a fresh two-rank state, in the JAX package's
    ``load_state`` and in a one-rank port state, each bit for bit the
    nets the run saved; the one-rank state trains on."""
    from trainner_tpu.train.cyclegan_trainer import \
        CycleGANTrainer as JaxTrainer
    from trainner_tpu.utils import checkpoint as JC
    from trainner_tpu_torch.utils import checkpoint
    from trainner_tpu_torch.utils.torch_interop import (
        cyclegan_state_from_jax, train_state_to_jax)

    res, path = two_ranks
    saved, loaded = res["cyclegan"], res["cyclegan_loaded"]
    assert loaded["step"] == STEPS
    for w in ("g", "d_a", "d_b"):
        for k, v in saved[w].items():
            assert torch.equal(loaded[w][k], v), (w, k)
    opt = W.options("cyclegan")
    trainer = create_trainer(copy.deepcopy(opt), device="cpu", graphs=False)
    state, meta = checkpoint.load_state(path, trainer.init_state(5))
    assert state.step == STEPS == meta["iter"]
    for w in ("g", "d_a", "d_b"):
        for k, v in getattr(state, w).net.state_dict().items():
            assert torch.equal(v, saved[w][k]), (w, k)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    template = jt.init_state(jax.random.PRNGKey(0), (2, 32, 32, 3))
    jstate, jmeta = JC.load_state(path, template)
    assert int(jstate.step) == STEPS == jmeta["iter"]
    from flax import serialization

    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    carried = cyclegan_state_from_jax(tree, state)
    for w in ("g", "d_a", "d_b"):
        for k, v in carried[w].items():
            assert torch.equal(v, saved[w][k]), (w, k)
    # the one-rank port state writes back the tree the JAX one holds
    mine = train_state_to_jax(state)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(mine["g"]["params"])[0],
            jax.tree_util.tree_flatten_with_path(tree["g"]["params"])[0]):
        assert pa == pb and np.array_equal(np.asarray(a), b)
    b = W.batch("cyclegan", STEPS)
    state, logs = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert state.step == STEPS + 1
    assert all(np.isfinite(float(v)) for v in logs.values())


def test_rank_parts_of_a_list_of_train_datasets_make_the_batch():
    """A list of train datasets on a data axis (``create_dataloader``
    with ``part``): every rank's weighted loader draws the same dataset
    for each batch from ``default_rng(seed + epoch)`` and reads its part
    of that batch; the parts in rank order are the one-process batches,
    with the same ``dataset_index``, epoch after epoch."""
    from trainner_tpu_torch.data.loader import (WeightedMultiLoader,
                                                create_dataloader)
    from trainner_tpu_torch.parallel import mesh as M

    class Items:
        def __init__(self, base, n):
            self.base, self.n = base, n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return {"HR": np.full((2, 2, 1), self.base + i, np.float32)}

    class Rank:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

    def epochs(loader, n=2):
        return [[(b["dataset_index"], b["HR"][:, 0, 0, 0].tolist())
                 for b in loader] for _ in range(n)]

    sets = [Items(0, 24), Items(100, 40), Items(1000, 16)]
    opt = {"phase": "train", "batch_size": 8, "n_workers": 1, "seed": 5,
           "sampler_weights": [1.0, 2.0, 1.0]}
    whole = epochs(create_dataloader(sets, opt))
    assert {i for e in whole for i, _ in e} == {0, 1, 2}
    for world in (2, 4):
        parts = []
        for r in range(world):
            loader = create_dataloader(
                sets, opt, part=M.local_batch_slice(8, Rank(r, world)))
            assert isinstance(loader, WeightedMultiLoader)
            parts.append(epochs(loader))
        for e in range(2):
            assert len(whole[e]) == len(parts[0][e])
            for i, (k, batch) in enumerate(whole[e]):
                assert all(p[e][i][0] == k for p in parts)
                assert sum((p[e][i][1] for p in parts), []) == batch


def test_fsdp_over_a_net_of_small_leaves_keeps_them_whole():
    """An fsdp axis over a net whose every leaf is below the rule's
    smallest split (a narrow PBR G): the sharded optimizer keeps each
    leaf whole and its step is the plain optimizer's, bit for bit (its
    step once raised on the empty list of split leaves)."""
    from trainner_tpu_torch.parallel import mesh as M
    from trainner_tpu_torch.train.optimizers import build_optimizer, jax_view

    nets = []
    for _ in range(2):
        net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3),
                                  torch.nn.Conv2d(8, 3, 3))
        torch.manual_seed(0)
        for p in net.parameters():
            torch.nn.init.normal_(p)
        nets.append(net)
    opts = []
    for net in nets:
        params = list(net.parameters())
        opts.append(build_optimizer(params, "adam",
                                    views=[jax_view(p) for p in params]))
    sharded = M.ShardedOptimizer(opts[1], M.Mesh(1, 2))
    assert all(d is None for d in sharded.dims)
    x = torch.rand(2, 3, 8, 8)
    for net, opt in ((nets[0], opts[0]), (nets[1], sharded)):
        opt.zero_grad()
        net(x).square().mean().backward()
        opt.step(1e-2)
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
