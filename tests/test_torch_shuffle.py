"""The per-sample shuffle of the degradation stages
(``shuffle_degradations``) in the port's ``data/pipeline.py`` against the
JAX package's: the host routing plans bit for bit, the routed and the
candidate-select programs on deterministic stand-in stages on the same
plan (1e-6), and the real bsrgan pipeline with the shuffle on under the
five statistical gates of ``tests/test_torch_pipeline.py``.

The JAX routed program pads a batch by repeating its first samples once,
which under-fills below k samples (ROADMAP Queue C 9), so no fixture here
uses a batch of 1 or 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import (BS, CROP, N_STAT, SCALE, _bsrgan_opt,
                                 _fractal, _gate, _gen, _t)
from trainner_tpu.data import pipeline as JP
from trainner_tpu.ops.imresize import imresize_np
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import pipeline as P
from trainner_tpu_torch.ops import blur
from trainner_tpu_torch.options.config import parse_dict

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side blurs by its conv path (cross-correlation)."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


def _shuffle_opt(**extra):
    opt = _bsrgan_opt()
    opt["datasets"]["train"].update(shuffle_degradations=True, **extra)
    return opt


def _pair():
    ds_j = jax_parse_dict(_shuffle_opt(), is_train=True)["datasets"]["train"]
    ds_p = parse_dict(_shuffle_opt(), is_train=True)["datasets"]["train"]
    return JP.BatchDegrader(ds_j, "lr"), P.BatchDegrader(ds_p, "lr")


# deterministic stand-ins that do not commute with one another; on the
# 1/255 lattice both frameworks compute them exactly alike
def _stand_ins(resize: bool):
    a = ("a", lambda r, x: x * 0.5, lambda g, x: x * 0.5)
    b = ("b", lambda r, x: x + 0.25, lambda g, x: x + 0.25)
    c = ("c", lambda r, x: 1.0 - x, lambda g, x: 1.0 - x)
    res = ("resize", lambda r, x: x[:, ::2, ::2], lambda g, x: x[:, ::2, ::2])
    stages = [a, b, res, c] if resize else [a, b, c]
    return ([(n, fj) for n, fj, _ in stages],
            [(n, fp) for n, _, fp in stages])


def _stand_in_pair(resize: bool):
    opt = {"scale": 4, "lr_noise": True, "lr_noise_types": ["gaussian"],
           "shuffle_degradations": True, "aug_configs": {}}
    jdeg, pdeg = JP.BatchDegrader(dict(opt), "lr"), \
        P.BatchDegrader(dict(opt), "lr")
    jdeg.stages, pdeg.stages = _stand_ins(resize)
    for deg in (jdeg, pdeg):
        deg._resize_finals, deg._comp_finals = [], []
    jdeg._jitted, pdeg._programs = {}, {}
    assert jdeg.shuffle and pdeg.shuffle
    return jdeg, pdeg


def _lattice(b, h, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (b, h, h, 3)) / 255.0).astype(np.float32)


@pytest.mark.parametrize("b", [3, 8, 32])
def test_routing_plans_are_the_jax_plans(b):
    """Several plans in a row from the same SeedSequence, for the bsrgan
    stages (k = 6: five shuffled stages and the resize) and for stand-ins
    with no resize: (idx, inv, act_a, act_b, npad) bit for bit."""
    jdeg, pdeg = _pair()
    assert [n for n, _ in pdeg.stages] == [n for n, _ in jdeg.stages]
    js, ps = _stand_in_pair(False)
    for jd, pd in ((jdeg, pdeg), (js, ps)):
        rj = np.random.default_rng(np.random.SeedSequence(P.PLAN_SEED))
        rp = np.random.default_rng(np.random.SeedSequence(0x5EED_0A71))
        for _ in range(4):
            want = jd._routing_plan(rj, b)
            got = pd._routing_plan(rp, b)
            assert got[4] == want[4]
            for g, w in zip(got[:4], want[:4]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_the_degrader_draws_the_jax_plan_stream(monkeypatch):
    """The routed program's plans come from the JAX package's host stream,
    call for call: the plans the degrader hands its program are those of a
    fresh ``SeedSequence(0x5EED_0A71)`` stream."""
    _, pdeg = _stand_in_pair(True)
    seen = []
    orig = pdeg._routing_plan

    def spy(rng, b):
        plan = orig(rng, b)
        seen.append(plan)
        return plan

    monkeypatch.setattr(pdeg, "_routing_plan", spy)
    x = torch.from_numpy(_lattice(8, 8, 0))
    for _ in range(3):
        pdeg(_gen(), x)
    jdeg, _ = _stand_in_pair(True)
    rj = np.random.default_rng(np.random.SeedSequence(0x5EED_0A71))
    for plan in seen:
        for g, w in zip(plan[:4], jdeg._routing_plan(rj, 8)[:4]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("resize", [True, False])
@pytest.mark.parametrize("b", [3, 8, 13])
def test_routed_program_matches_jax_on_the_same_plan(resize, b):
    jdeg, pdeg = _stand_in_pair(resize)
    x = _lattice(b, 8, b)
    plan = pdeg._routing_plan(np.random.default_rng(b), b)
    want = np.asarray(jdeg._build_routing()(KEY, jnp.asarray(x),
                                            *plan[:4]))
    got = pdeg._build_routing()(_gen(), _t(x), *(_t(a) for a in plan[:4]))
    assert got.shape == want.shape == ((b, 4, 4, 3) if resize
                                       else (b, 8, 8, 3))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("resize", [True, False])
@pytest.mark.parametrize("b", [3, 16])
def test_candidate_select_matches_jax_on_the_same_scores(resize, b):
    """The candidate-select program on the JAX program's own per-sample
    scores (its first split of the key), repeated here."""
    jdeg, pdeg = _stand_in_pair(resize)
    m = len(pdeg.stages) - resize
    x = _lattice(b, 8, 20 + b)
    want = np.asarray(jdeg._build_persample()(KEY, jnp.asarray(x)))
    r_perm = jax.random.split(KEY, 6)[0]
    scores = jax.random.uniform(r_perm, (b, m + resize))
    got = pdeg._build_persample()(_gen(), _t(x), scores=_t(scores))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("routing", ["1", "0"])
def test_both_orders_appear_within_one_batch(routing, monkeypatch):
    """Two stages that do not commute, on zeros: a-then-b gives 0.25,
    b-then-a 0.125, and one batch holds both, each often (p = 1/2)."""
    monkeypatch.setenv("TRAINNER_SHUFFLE_ROUTING", routing)
    _, pdeg = _stand_in_pair(False)
    pdeg.stages = pdeg.stages[:2]
    y = pdeg(_gen(1), torch.zeros(64, 8, 8, 3)).numpy()
    per_sample = np.round(y.mean(axis=(1, 2, 3)), 3)
    vals = sorted(set(per_sample.tolist()))
    assert len(vals) == 2, vals
    assert abs(vals[0] - 0.125) < 2e-3 and abs(vals[1] - 0.25) < 2e-3
    assert 16 <= int((per_sample > 0.18).sum()) <= 48


def test_small_batches_are_padded_by_repetition():
    """Below k samples the port repeats the batch to fill the plan, where
    the JAX program under-fills; the output keeps the batch's size."""
    _, pdeg = _stand_in_pair(True)
    for b in (1, 2):
        y = pdeg(_gen(), torch.from_numpy(_lattice(b, 8, b)))
        assert y.shape == (b, 4, 4, 3)


def test_plans_reach_the_device_as_int32_and_bool():
    _, pdeg = _pair()
    plan = pdeg._routing_plan(np.random.default_rng(0), 8)
    idx, inv, act_a, act_b = P.plan_to_device(plan[:4], torch.device("cpu"))
    assert idx.dtype == inv.dtype == torch.int32
    assert act_a.dtype == act_b.dtype == torch.bool
    for t, a in zip((idx, inv, act_a, act_b), plan[:4]):
        np.testing.assert_array_equal(t.numpy(), a)


def test_the_bsrgan_stages_run_on_q_slices():
    """With the bsrgan presets the routed program runs blur and blur2 once
    per slot and pass, each on its q-slice: at b = 32, k = 6 symbols give
    npad 36 and q 6, so 12 blur launches at the input canvas and 12 at the
    LR canvas per batch."""
    _, pdeg = _pair()
    assert pdeg.shuffle
    shapes = []
    orig = blur.blur_per_sample_plain

    def spy(x, k):
        shapes.append(tuple(x.shape))
        return orig(x, k)

    x = torch.from_numpy(_lattice(32, CROP, 1))
    try:
        blur.blur_per_sample_plain = spy
        y = pdeg(_gen(2), x)
    finally:
        blur.blur_per_sample_plain = orig
    assert y.shape == (32, CROP // SCALE, CROP // SCALE, 3)
    assert shapes.count((6, CROP, CROP, 3)) == 12
    assert shapes.count((6, CROP // SCALE, CROP // SCALE, 3)) == 12
    assert len(shapes) == 24


@pytest.mark.parametrize("routing", ["1", "0"])
def test_bsrgan_shuffled_statistics_match_jax(routing, monkeypatch):
    """The bsrgan pipeline with the per-sample shuffle, routed and by
    candidate select, against the JAX package's shuffled pipeline of the
    same kind, on 256 samples of one 1/f fixture: the five gates."""
    monkeypatch.setenv("TRAINNER_SHUFFLE_ROUTING", routing)
    jax_deg, port_deg = _pair()
    crop = _fractal(CROP, seed=11)
    crop = np.round(crop * 255.0).astype(np.float32) / 255.0
    clean = np.clip(imresize_np(crop, 1.0 / SCALE, kernel="cubic"), 0, 1)
    x = np.repeat(crop[None], BS, 0)
    gen = _gen(5)
    ref, ours = [], []
    for i in range(N_STAT // BS):
        ref.append(np.asarray(jax_deg(jax.random.PRNGKey(i),
                                      jnp.asarray(x))))
        ours.append(port_deg(gen, _t(x)).numpy())
    ref, ours = np.concatenate(ref), np.concatenate(ours)
    lr = CROP // SCALE
    assert ours.shape == ref.shape == (N_STAT, lr, lr, 3)
    assert np.abs(ours * 255.0 - np.round(ours * 255.0)).max() <= 1e-4
    print(_gate(f"bsrgan shuffled, routing {routing}", ref, ours, clean))


def test_the_producer_runs_the_shuffled_program(tmp_path):
    """``shuffle_degradations: true`` through the producer of
    ``tests/test_torch_producer.py`` (loader, uint8 wire, the degrader of
    ``make_otf_degradation``) and one train step, on the CPU."""
    from test_torch_producer import _field, _options
    from trainner_tpu_torch.data import (common, create_dataloader,
                                         create_dataset)
    from trainner_tpu_torch.train import (batches, create_trainer,
                                          make_otf_degradation)

    for i in range(7):
        common.save_img(_field(48, 56, seed=i), str(tmp_path / f"{i}.png"))
    opt = parse_dict(_options(str(tmp_path), shuffle_degradations=True),
                     is_train=True)
    loader = create_dataloader(create_dataset(opt["datasets"]["train"]),
                               opt["datasets"]["train"])
    degrade = make_otf_degradation(opt, device="cpu")
    trainer = create_trainer(opt, device="cpu")
    state = trainer.init_state(0)
    batch = degrade(next(batches(loader, "cpu")))
    assert batch["LR"].shape == (7, 8, 8, 3)
    assert np.abs(batch["LR"].numpy() * 255
                  - np.round(batch["LR"].numpy() * 255)).max() <= 1e-3
    state, logs = trainer.train_step(state, batch)
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in logs.values())


def test_static_plan_buffers_give_the_plans_of_plan_to_device():
    """A graphed routed program reads its plans from one static buffer,
    filled through two host buffers in turn: plan after plan it holds the
    int32 and bool plans that ``plan_to_device`` makes, at one storage."""
    _, pdeg = _pair()
    rng = np.random.default_rng(0)
    plans = [pdeg._routing_plan(rng, 8)[:4] for _ in range(3)]
    cpu = torch.device("cpu")
    buf = P.PlanBuffer(plans[0][0].shape, cpu)
    ptr = buf.dev.data_ptr()
    for plan in plans:
        got = buf.upload(plan)
        want = P.plan_to_device(plan, cpu)
        for g, w, a in zip(got, want, plan):
            assert g.dtype == w.dtype and torch.equal(g, w)
            np.testing.assert_array_equal(g.numpy(), a)
        assert buf.dev.data_ptr() == ptr
        assert got[0].data_ptr() == ptr
    assert not np.array_equal(plans[0][0], plans[1][0])


@pytest.mark.parametrize("routing", ["1", "0"])
def test_the_graph_body_is_the_eager_program(routing, monkeypatch):
    """The degradation step's device program with its plans read from
    static buffers (what a graph captures) gives the eager step's output
    from the same generator state bit for bit, batch after batch; and the
    step gives what ``BatchDegrader`` gives when called on the batch."""
    from trainner_tpu_torch.train.producer import make_otf_degradation

    monkeypatch.setenv("TRAINNER_SHUFFLE_ROUTING", routing)
    opt = parse_dict(_shuffle_opt(), is_train=True)
    eager = make_otf_degradation(opt, "cpu", _gen(5))
    body = make_otf_degradation(opt, "cpu", _gen(5))
    deg = P.BatchDegrader(opt["datasets"]["train"], "lr")
    gen = _gen(5)
    buffers = {}
    for seed in range(2):
        hr = torch.from_numpy(np.stack([
            np.round(_fractal(CROP, seed * 8 + i) * 255) for i in range(8)
        ]).astype(np.uint8))
        want = eager({"HR": hr})["LR"]
        _, plan = body._plans({"HR": hr})
        assert (plan is not None) == (routing == "1")
        if plan is not None:
            buf = buffers.setdefault(
                "lr", P.PlanBuffer(plan[0].shape, torch.device("cpu")))
            buf.upload(plan)
            plan = P.split_plan(buf.dev)
        _, got = body._body(hr, None, None, plan)
        assert torch.equal(got, want)
        assert torch.equal(deg(gen, hr), want)
