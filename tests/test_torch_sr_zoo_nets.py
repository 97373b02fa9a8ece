"""The ``sr`` trainer's other generators (``abpn_net``, ``asr_resnet``,
``asr_cnn``, ``seg_arch``; ``trainner_tpu_torch/models/abpn.py``,
``asrresnet.py``, ``seg.py``), ``ADiscriminator``, ``SelfAttentionBlock``
with spectral norm and ``bicubic_torch`` against the JAX package on the
CPU. The port's init (with every tensor moved by a seeded draw) is carried
into the flax trees by ``flax_paths`` (the tree's structure and shapes
checked against the flax init's, traced), so both run the same weights and
state: each forward f32 within 1e-5 of its output's size, eval mode and
train mode (batch statistics, the spectral norms' power step, then the
state each commits: u and sigma under flax's names, written once). ABPN
at dim 8 with 4 of its 10 stages (the stage code is the same), the ASR
nets at nf 16, the segmenter at its fixed widths on 32 px images (4 x 4
at its stride 8: batch statistics of 32 values a channel). One
``SRTrainer`` step (pixel loss, SGD, f32) with each G against the JAX
step: logs within 1e-4 relative, G's tensors within 1e-5; the
segmenter's dropout fed the JAX package's own mask. The segmenter in
train mode (its forward, the statistics it commits, its step) is held to
the JAX package in f64: the port's code run in f64 against the flax net
run under ``jax.enable_x64`` with the same dropout mask, at
the tolerances above. Its f32 result is held to that f64 result too
(``_witnessed``: no further from it than the JAX package's f32 result),
since f32 holds neither package to 1e-5 of the other there.
"""

import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _check_logs, _numpy
from trainner_tpu.models import abpn as JA
from trainner_tpu.models import asrresnet as JR
from trainner_tpu.models import networks as jnetworks
from trainner_tpu.models import seg as JS
from trainner_tpu.ops import blocks as JB
from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer
from trainner_tpu.train.state import NetState as JNetState
from trainner_tpu.train.state import SRTrainState as JState
from trainner_tpu_torch.models import abpn as PA
from trainner_tpu_torch.models import asrresnet as PR
from trainner_tpu_torch.models import networks as pnetworks
from trainner_tpu_torch.models import seg as PS
from trainner_tpu_torch.ops import blocks as PB
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train.sr_trainer import SRTrainer
from trainner_tpu_torch.utils.torch_interop import (net_to_jax,
                                                    train_state_from_jax)

torch.set_num_threads(2)

NETS = {
    "abpn": (lambda: JA.ABPN(dim=8, n_stages=4),
             lambda: PA.ABPN(dim=8, n_stages=4), (1, 8, 8, 3)),
    "asr_resnet": (lambda: JR.ASRResNet(nf=16, max_pool=True, poolsize=2),
                   lambda: PR.ASRResNet(nf=16, max_pool=True, poolsize=2),
                   (2, 8, 8, 3)),
    "asr_cnn": (lambda: JR.ASRCNN(nf=16, finalact="tanh"),
                lambda: PR.ASRCNN(nf=16, finalact="tanh"), (2, 8, 8, 3)),
    "adiscriminator": (lambda: JR.ADiscriminator(return_maps=True),
                       lambda: PR.ADiscriminator(return_maps=True),
                       (2, 32, 32, 3)),
    "adiscriminator_bn": (
        lambda: JR.ADiscriminator(spectral_norm=False, self_attention=False),
        lambda: PR.ADiscriminator(spectral_norm=False, self_attention=False),
        (2, 32, 32, 3)),
    "seg": (lambda: JS.OutdoorSceneSeg(), lambda: PS.OutdoorSceneSeg(),
            (2, 32, 32, 3)),
}


class _JaxDropout(fnn.Module):
    """A dropout at the segmenter's flax path (the root's ``Dropout_0``):
    the mask the JAX package draws there from ``rngs={"dropout": key}``."""

    @fnn.compact
    def __call__(self, x):
        return fnn.Dropout(0.1, deterministic=False)(x)


def _jax_dropout(seg, key, shape):
    """The port's segmenter drops what the JAX one drops from ``key``;
    returns the kept positions (NHWC)."""
    keep = np.array(_JaxDropout().apply({}, jnp.ones(shape),
                                        rngs={"dropout": key}) > 0)
    mask = torch.from_numpy(keep).permute(0, 3, 1, 2)
    seg.dropout.forward = lambda x: torch.where(mask, x / 0.9,
                                                torch.zeros_like(x))
    return keep


@contextlib.contextmanager
def _jax_f64(keep):
    """The JAX package run in f64, with ``keep`` as its dropout mask (an
    f64 draw from the same key keeps other positions)."""
    def masked(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return jnp.where(keep, args[0] / 0.9, 0.0)
        return next_fun(*args, **kwargs)

    with jax.enable_x64(True), fnn.intercept_methods(masked):
        yield


def _f64_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


def _moved(pm, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pm.parameters():
            p.mul_(1 + 0.3 * torch.randn(p.shape, generator=gen))
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, b in pm.named_buffers():
            if name.endswith("running_var"):
                b.add_(0.5 * torch.rand(b.shape, generator=gen))


def _calibrated(pm, x):
    """Running statistics set to one train-mode pass's batch statistics,
    the variance plus 1 (no norm then amplifies): the segmenter's 33
    bottlenecks in eval mode see bounded activations, not logits in the
    thousands, where f32's softmax saturates in both packages alike and
    the comparison would hold nothing."""
    norms = [m for m in pm.modules() if isinstance(m, PB.BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    pm.train()
    with torch.no_grad():
        pm(torch.from_numpy(x))
    PB.commit_stats(pm)
    with torch.no_grad():
        for m in norms:
            m.momentum = 0.99
            m.running_var.add_(1.0)


@contextlib.contextmanager
def _f64():
    """The port's code run in f64, a witness: ``.float()`` keeps an f64
    tensor f64 and new tensors default to f64."""
    plain = torch.Tensor.float
    default = torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self \
        if self.dtype == torch.float64 else plain(self, *a, **k)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = plain
        torch.set_default_dtype(default)


def _witnessed(got, want, exact, label):
    """The segmenter in train mode, where f32 holds neither package to
    1e-5: its 37 batch norms take E[x^2] - E[x]^2 of shifted activations
    (the same fast variance in both), whose rounding differs with the
    order of the sums and grows through the depth (to about 5e-4 of the
    output). The port's f32 result is held to the f64 witness of the
    port's own code (which the callers hold to the JAX package's f64
    run): no further from it than twice the JAX package's f32 result,
    plus 1e-6 of the output's size."""
    got, want, exact = (np.asarray(t, np.float64) for t in (got, want,
                                                            exact))
    e_port = np.abs(got - exact).max()
    e_jax = np.abs(want - exact).max()
    assert e_port <= 2 * e_jax + 1e-6 * np.abs(exact).max(), \
        (label, e_port, e_jax)


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert np.shape(x) == np.shape(y)


def _variables(jm, pm, x):
    """The port's moved weights and state as flax variables; their tree
    checked against the flax init's (traced only)."""
    params, stats = net_to_jax(pm.state_dict(), pm)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False))
    _same_tree(shapes["params"], params)
    if stats:
        _same_tree(shapes["batch_stats"], stats)
        return {"params": params, "batch_stats": stats}
    assert "batch_stats" not in shapes
    return {"params": params}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [o for part in out for o in _flat(part)]
    return [out]


def close(got, want, tol=1e-5):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3))


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(name, train):
    jf, pf, shape = NETS[name]
    jm, pm = jf(), pf()
    pm.init_weights(torch.Generator().manual_seed(0))
    _moved(pm, 1)
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    if name == "seg":
        _calibrated(pm, x)
    v = _variables(jm, pm, x)
    mutable = ["batch_stats"] if train and "batch_stats" in v else False
    key = jax.random.PRNGKey(4)
    out = jax.jit(lambda vv: jm.apply(vv, jnp.asarray(x), train=train,
                                      mutable=mutable,
                                      rngs={"dropout": key}))(v)
    want, new = (out if mutable else (out, None))
    pm.train(train)
    if name == "seg" and train:
        keep = _jax_dropout(pm, key,
                            (shape[0], shape[1] // 8, shape[2] // 8, 512))
        pm64 = copy.deepcopy(pm).double()
        pm64.dtype = torch.float64
        with _f64(), torch.no_grad():
            exact = pm64(torch.from_numpy(x).double())
        PB.commit_stats(pm64)
        with _jax_f64(keep):
            want64, new64 = JS.OutdoorSceneSeg(dtype=jnp.float64).apply(
                _f64_tree(v), jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"])
            assert want64.dtype == jnp.float64
        close(exact, np.asarray(want64))
        _, stats64 = net_to_jax(pm64.state_dict(), pm64)
        _same_tree(new64["batch_stats"], stats64)
        for a, b in zip(jax.tree_util.tree_leaves(stats64),
                        jax.tree_util.tree_leaves(new64["batch_stats"])):
            close(np.asarray(a), np.asarray(b))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    if name == "seg" and train:
        _witnessed(got.numpy(), want, exact.numpy(), name)
        return
    for g, w in zip(_flat(got), _flat(want)):
        close(g, w)
    if new is not None:
        PB.commit_stats(pm)
        _, stats = net_to_jax(pm.state_dict(), pm)
        _same_tree(new["batch_stats"], stats)
        for a, b in zip(jax.tree_util.tree_leaves(stats),
                        jax.tree_util.tree_leaves(new["batch_stats"])):
            close(a, b)


@pytest.mark.parametrize("max_pool", [False, True])
def test_self_attention_with_spectral_norm(max_pool):
    """The block's flax names (f, g, h under SpectralNorm_0-2, gamma), its
    train-mode output and the power step's state, committed once."""
    jm = JB.SelfAttentionBlock(max_pool=max_pool, poolsize=2,
                               spectral_norm=True)
    pm = PB.SelfAttentionBlock(16, max_pool=max_pool, poolsize=2,
                               spectral_norm=True)
    PB.lecun_init(pm, torch.Generator().manual_seed(0))
    _moved(pm, 2)
    assert {"f.sn.u", "h.sn.sigma", "gamma"} <= set(PB.named_flax_paths(pm))
    x = np.random.RandomState(1).randn(2, 8, 8, 16).astype(np.float32)
    holder = torch.nn.Module()
    holder.flax_paths = lambda: PB.named_flax_paths(pm)
    params, stats = net_to_jax(pm.state_dict(), holder)
    assert set(stats) == {"SpectralNorm_0", "SpectralNorm_1",
                          "SpectralNorm_2"}
    assert set(stats["SpectralNorm_1"]) == {"g/kernel/u", "g/kernel/sigma"}
    want, new = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), want)
    before = pm.f.sn.u.clone()
    PB.commit_stats(pm)
    assert not torch.equal(before, pm.f.sn.u)
    _, stats = net_to_jax(pm.state_dict(), holder)
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(new["batch_stats"])):
        close(a, b)
    pm.eval()
    with torch.no_grad():
        pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert pm.f.sn.pending is None


@pytest.mark.parametrize("scale,size", [(4, None), (0.25, None),
                                        (None, (13, 7))])
def test_bicubic_torch(scale, size):
    x = np.random.RandomState(2).rand(2, 16, 12, 3).astype(np.float32)
    close(PB.bicubic_torch(torch.from_numpy(x), scale, size),
          JB.bicubic_torch(jnp.asarray(x), scale, size))


def _sr_options(network_G, scale, px):
    opt = {"name": "zoo_steps", "model": "sr", "scale": scale,
           "use_amp": False,
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/x",
                                  "crop_size": px * scale,
                                  "batch_size": 2}},
           "network_G": network_G, "path": {"root": "/tmp/zoo_steps"},
           "train": {"lr_G": 1e-2, "optim_G": "sgd", "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "lr_scheme": "MultiStepLR",
                     "lr_steps": [50]}}
    return dict(parse_dict(opt, is_train=True))




@pytest.mark.parametrize("network_G,scale,px", [
    ({"type": "abpn_net", "nf": 8}, 4, 8),
    ({"type": "asr_resnet", "nf": 16, "poolsize": 2}, 4, 8),
    ({"type": "asr_cnn", "nf": 16, "poolsize": 2}, 4, 8),
    ({"type": "seg_arch", "n_classes": 3}, 1, 32),
], ids=["abpn", "asr_resnet", "asr_cnn", "seg"])
def test_sr_step_matches_jax(network_G, scale, px, monkeypatch):
    """One ``sr`` step with the G: the JAX step's logs and G's tensors."""
    if network_G["type"] == "abpn_net":
        monkeypatch.setitem(jnetworks._G_REGISTRY, "abpn_net",
                            lambda cfg, dtype: JA.ABPN(
                                dim=cfg["dim"], n_stages=4, dtype=dtype))
        monkeypatch.setitem(pnetworks._G_REGISTRY, "abpn_net",
                            lambda cfg, dtype: PA.ABPN(
                                dim=cfg["dim"], n_stages=4, dtype=dtype))
    opt = _sr_options(network_G, scale, px)
    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    pt = SRTrainer(copy.deepcopy(opt), dtype=torch.float32, device="cpu")
    pstate = pt.init_state(0)
    _moved(pstate.g.net, 3)
    rng = np.random.RandomState(0)
    batch = {"LR": rng.rand(2, px, px, 3).astype(np.float32),
             "HR": rng.rand(2, px * scale, px * scale,
                            3).astype(np.float32)}
    v = _variables(jt.netG, pstate.g.net, batch["LR"])
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JState(step=jnp.zeros([], jnp.int32), rng=jax.random.PRNGKey(3),
                    g=JNetState(params=params, opt_state=jt.optG.init(params),
                                extra={k: v[k] for k in v if k != "params"}))
    net = pstate.g.net
    seg = isinstance(net, PS.OutdoorSceneSeg)
    if seg:
        # the JAX step's G key (sr_trainer.py:305)
        keep = _jax_dropout(net, jax.random.split(jstate.rng, 5)[4],
                            (2, px // 8, px // 8, 512))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    if seg:  # the port's step in f64, from the same state
        with _jax_f64(keep):
            jt64 = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float64)
            v64 = _f64_tree(v)
            jstate64 = JState(
                step=jnp.zeros([], jnp.int32), rng=jax.random.PRNGKey(3),
                g=JNetState(params=v64["params"],
                            opt_state=jt64.optG.init(v64["params"]),
                            extra={"batch_stats": v64["batch_stats"]}))
            jstate64, jlogs64 = jt64.train_step(jstate64, {
                k: jnp.asarray(v_, jnp.float64) for k, v_ in batch.items()})
            want64 = train_state_from_jax(
                _numpy(jstate64.g.params), None, None, 1, g_net=net,
                g_batch_stats=_numpy(jstate64.g.extra["batch_stats"]))["g"]
        with _f64():
            pt64 = SRTrainer(copy.deepcopy(opt), dtype=torch.float64,
                             device="cpu")
            state64 = pt64.init_state(0)
        state64.g.net.load_state_dict(before)
        state64.g.net.dropout.forward = net.dropout.forward
    jstate, jlogs = jt.train_step(
        jstate, {k: jnp.asarray(v_) for k, v_ in batch.items()})
    pstate, logs = pt.train_step(
        pstate, {k: torch.from_numpy(v_) for k, v_ in batch.items()})
    want = train_state_from_jax(
        _numpy(jstate.g.params), None, None, 1, g_net=net,
        g_batch_stats=_numpy(jstate.g.extra.get("batch_stats")))["g"]
    if seg:
        with _f64():
            _, logs64 = pt64.train_step(state64, {
                k: torch.from_numpy(v_).double() for k, v_ in batch.items()})
        _check_logs(logs64, jlogs64, 1e-4, 0)
        exact = state64.g.net.state_dict()
        for k, t in exact.items():
            assert t.dtype == torch.float64, k
            w = want64[k].numpy()
            assert np.abs(t.numpy() - w).max() <= 1e-5 * max(
                np.abs(w).max(), 1.0), k
        for k in jlogs:
            _witnessed(float(logs[k]), float(jlogs[k]), float(logs64[k]), k)
        for k, t in net.state_dict().items():
            _witnessed(t.numpy(), want[k].numpy(), exact[k].numpy(), k)
        return
    _check_logs(logs, jlogs, 1e-4, 0)
    for k, t in net.state_dict().items():
        w = want[k].numpy()
        assert np.abs(t.numpy() - w).max() <= 1e-5 * max(
            np.abs(w).max(), 1.0), k
