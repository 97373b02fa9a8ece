"""Band-parallel serving of the port (``trainner_tpu_torch/parallel/
spatial.py``, ``SRTrainer.eval_step_spatial``) against the JAX package's
(``trainner_tpu/parallel/spatial.py`` on 4 of conftest's 8 virtual CPU
devices), with the same weights and input, over the WHOLE output, the
outer rows included: both cut the bands with zero halos at the image's
edges, so where one forward would pad each conv they agree with each
other, not with the whole-image forward. f32; tolerance 1e-5 of the
output's size (two conv implementations sum in other orders).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from trainner_tpu.parallel import spatial as JS
from trainner_tpu_torch.parallel import spatial as S
from trainner_tpu_torch.train.sr_trainer import create_trainer
from trainner_tpu_torch.utils.torch_interop import g_from_jax

torch.set_num_threads(2)
REL = 1e-5
CPU4 = ["cpu"] * 4


def _stack(n_layers, seed, nf=8, up=1):
    """A SAME 3x3 conv stack with biases and LeakyReLU (then a nearest
    up-scale by ``up``) as one JAX function and one torch function on the
    same numpy weights."""
    rng = np.random.default_rng(seed)
    widths = [3] + [nf] * (n_layers - 1) + [3]
    ws = [(rng.standard_normal((3, 3, widths[i], widths[i + 1])) * 0.3
           ).astype(np.float32) for i in range(n_layers)]
    bs = [(rng.standard_normal(widths[i + 1]) * 0.1).astype(np.float32)
          for i in range(n_layers)]

    def jax_fn(x):
        for i, (w, b) in enumerate(zip(ws, bs)):
            x = jax.lax.conv_general_dilated(
                x, w, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
            if i < n_layers - 1:
                x = jax.nn.leaky_relu(x, 0.2)
        return jnp.repeat(jnp.repeat(x, up, axis=1), up, axis=2)

    def torch_fn(x, dev=None):
        y = x.permute(0, 3, 1, 2)
        for i, (w, b) in enumerate(zip(ws, bs)):
            y = F.conv2d(y, torch.from_numpy(w).permute(3, 2, 0, 1),
                         torch.from_numpy(b), padding=1)
            if i < n_layers - 1:
                y = F.leaky_relu(y, 0.2)
        y = y.permute(0, 2, 3, 1)
        return y.repeat_interleave(up, 1).repeat_interleave(up, 2)

    return jax_fn, torch_fn


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("shape,halo,up", [((2, 32, 16, 3), 4, 1),
                                           ((1, 29, 12, 3), 3, 2),
                                           ((1, 32, 8, 3), 8, 1)])
def test_spatial_infer_matches_jax_everywhere(shape, halo, up):
    """Bands of a conv stack, the pad of H to a multiple of 4 (29 -> 32)
    and an up-scale: every output row as JAX's, the outer rows too."""
    jax_fn, torch_fn = _stack(3, seed=2, up=up)
    x = np.random.default_rng(3).random(shape, np.float32)
    want = JS.spatial_infer(jax_fn, jnp.asarray(x), JS.make_spatial_mesh(4),
                            halo=halo, scale=up)
    got = S.spatial_infer(torch_fn, torch.from_numpy(x), CPU4, halo=halo,
                          scale=up)
    _close(got, want)
    assert got.shape[1] == shape[1] * up


def test_halo_above_the_band_raises():
    with pytest.raises(ValueError, match="halo"):
        S.spatial_infer(lambda x, d: x, torch.zeros(1, 16, 8, 3),
                        ["cpu"] * 8, halo=4)
    one = S.spatial_infer(lambda x, d: x * 2, torch.ones(1, 5, 3, 3),
                          ["cpu"], halo=0)
    assert torch.equal(one, torch.full((1, 5, 3, 3), 2.0))


def _rrdb(nb=1):
    opt = {"is_train": False, "scale": 2,
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": nb, "gc": 8,
                         "upscale": 2, "gaussian_noise": False}}
    from trainner_tpu.train.sr_trainer import SRTrainer as JaxTrainer

    jt = JaxTrainer(copy.deepcopy(opt), dtype=jnp.float32)
    jstate = jt.init_state(jax.random.PRNGKey(0), (1, 16, 16, 3))
    pt = create_trainer(copy.deepcopy(opt), device="cpu")
    pstate = pt.init_state(0)
    params = jax.tree.map(np.asarray, jstate.g.params)
    pstate.g.net.load_state_dict(g_from_jax(params, None, pstate.g.net),
                                 strict=False)
    return jt, jstate, pt, pstate


@pytest.fixture(scope="module")
def rrdb():
    return _rrdb()


def test_eval_step_spatial_matches_jax_everywhere(rrdb):
    """``eval_step_spatial`` of an RRDB (nb 3, x2) in 4 bands of 16 rows,
    halo 8, against the JAX trainer's on the same weights: the whole
    output; and its interior (beyond halo x scale from the outer edge)
    against the whole-image ``eval_step``."""
    jt, jstate, pt, pstate = rrdb
    x = np.random.default_rng(7).random((1, 64, 24, 3), np.float32)
    want = jt.eval_step_spatial(jstate, jnp.asarray(x),
                                JS.make_spatial_mesh(4), halo=8)
    got = pt.eval_step_spatial(pstate, torch.from_numpy(x), CPU4, halo=8)
    _close(got, want)
    whole = pt.eval_step(pstate, torch.from_numpy(x))
    inner = slice(16, -16)
    _close(got[:, inner], whole[:, inner].numpy())


def test_effective_radius_matches_jax(rrdb):
    jt, jstate, pt, pstate = rrdb
    x = np.random.default_rng(8).random((1, 48, 16, 3), np.float32)

    def jax_fn(v):
        return jt.eval_step(jstate, v)

    def torch_fn(v):
        return pt.eval_step(pstate, v)

    for rtol in (1e-2, 1e-4):
        want = JS.effective_radius(jax_fn, jnp.asarray(x), rtol=rtol,
                                   scale=2)
        got = S.effective_radius(torch_fn, torch.from_numpy(x), rtol=rtol,
                                 scale=2)
        assert got == want, (rtol, got, want)
    assert S.receptive_radius(170, 4) == JS.receptive_radius(170, 4) == 170


def test_bands_on_another_device_run_a_kept_copy():
    """A band on a device other than the trainer's runs that device's copy
    of G (``torch.device("cpu", 0)`` is another device than the trainer's
    ``cpu`` here): the output equals the bands all on the trainer's device
    bit for bit; the copy is made once and kept; an in-place update of G
    is copied in, and so is a change that moves no version counter (as a
    step's replay) once the trainer marks its packs stale."""
    opt = {"is_train": False, "scale": 2,
           "network_G": {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 8,
                         "upscale": 2, "gaussian_noise": False}}
    pt = create_trainer(opt, device="cpu")
    st = pt.init_state(0)
    x = torch.from_numpy(
        np.random.default_rng(9).random((1, 32, 12, 3), np.float32))
    other = torch.device("cpu", 0)
    mixed = ["cpu", other, other, "cpu"]

    def both():
        return (pt.eval_step_spatial(st, x, mixed, halo=4),
                pt.eval_step_spatial(st, x, CPU4, halo=4))

    got, want = both()
    assert torch.equal(got, want)
    (key, entry), = pt._twins.items()
    assert key == ("g", other)
    twin = entry[2]
    w = st.g.net.conv_first.weight
    with torch.no_grad():
        w.mul_(1.5)
    got, want = both()
    assert torch.equal(got, want) and pt._twins[key][2] is twin
    w.data.mul_(0.5)   # moves no version counter
    assert not torch.equal(twin.conv_first.weight, w)
    pt._graph_state, pt._packs_stale = st, True
    got, want = both()
    assert torch.equal(got, want) and pt._twins[key][2] is twin
    assert torch.equal(twin.conv_first.weight, w)
