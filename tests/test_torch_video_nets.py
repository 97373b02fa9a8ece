"""SR3D, EDVR with its DCNv2, EVSRGAN's Conv3D ``RRDBNet`` and RIFE of the
port against the JAX package's on the CPU, at narrow widths on seeded
clips: the same flax weights in both (``test_torch_sofvsr.variables``,
carried both ways bit for bit), every forward f32 within 1e-5 of its size;
the modulated deformable conv alone (offsets of several pixels, past the
border) and its gradients; ``define_G`` building each net from the parsed
options with the JAX package's defaults and key aliases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sofvsr import carry, close, variables
from trainner_tpu.models import edvr as JE
from trainner_tpu.models import rife as JR
from trainner_tpu.models import rrdb as JRR
from trainner_tpu.models import sr3d as J3
from trainner_tpu.ops import deform_conv as JDC
from trainner_tpu.options.defaults import \
    get_network_G_config as jax_g_config
from trainner_tpu_torch.models import edvr as PE
from trainner_tpu_torch.models import rife as PR
from trainner_tpu_torch.models import rrdb as PRR
from trainner_tpu_torch.models import sr3d as P3
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.ops import deform_conv as PDC
from trainner_tpu_torch.options.defaults import get_network_G_config

torch.set_num_threads(2)


def _clip(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _forward(jm, pm, x, flax_named=True, **kw):
    v = variables(jm, x)
    pm = carry(v, pm, flax_named)
    with torch.no_grad():
        close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x),
                                                train=False, **kw))


@pytest.mark.parametrize("n,scale", [(5, 4), (7, 2), (3, 4)])
def test_sr3d_matches_jax(n, scale):
    kw = dict(nf=4, scale=scale, n_frames=n)
    _forward(J3.SR3DNet(**kw), P3.SR3DNet(**kw), _clip((2, n, 10, 12, 3)))


@pytest.mark.parametrize("extra", [{}, {"with_predeblur": True,
                                        "with_tsa": False},
                                   {"upsample_mode": "upconv"},
                                   {"upscale": 2, "center_frame_idx": 1}])
def test_edvr_matches_jax(extra):
    kw = dict(num_feat=16, num_frame=5, deformable_groups=4,
              num_extract_block=2, num_reconstruct_block=2, **extra)
    _forward(JE.EDVR(**kw), PE.EDVR(**kw), _clip((1, 5, 16, 16, 3)))


def test_modulated_deform_conv_and_its_gradients_match_jax():
    rng = np.random.RandomState(1)
    b, h, w, c, G = 2, 9, 11, 8, 2
    x = rng.rand(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, h, w, G * 9 * 2) * 3).astype(np.float32)
    mask = rng.rand(b, h, w, G * 9).astype(np.float32)
    wt = (rng.randn(3, 3, c, 5) * 0.2).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    probe = rng.rand(b, h, w, 5).astype(np.float32)

    def jf(x, off, mask, wt):
        return jnp.sum(JDC.modulated_deform_conv2d(
            x, off, mask, wt, jnp.asarray(bias), (3, 3), G) * probe)

    want = JDC.modulated_deform_conv2d(*map(jnp.asarray, (x, off, mask, wt)),
                                       jnp.asarray(bias), (3, 3), G)
    jgrads = jax.grad(jf, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, off, mask, wt)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, off, mask)]
    tw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))
                          ).requires_grad_(True)
    got = PDC.modulated_deform_conv2d(*ts, tw, torch.from_numpy(bias),
                                      (3, 3), G)
    close(got, want)
    (got * torch.from_numpy(probe)).sum().backward()
    for t, g in zip(ts, jgrads[:3]):
        close(t.grad, g, 1e-4)
    close(tw.grad.permute(2, 3, 1, 0), jgrads[3], 1e-4)


def test_evsrgan_conv3d_trunk_matches_jax():
    kw = dict(nf=8, nb=1, gc=4, gaussian_noise=False)
    _forward(JRR.RRDBNet(conv3d=True, **kw), PRR.RRDBNet(conv3d=True, **kw),
             _clip((2, 3, 8, 8, 3)), flax_named=False)


def test_rife_matches_jax_in_both_modes():
    """Eval mode (running statistics) and train mode (batch statistics,
    the five outputs) on a 64 px pair: IFBlock 0 normalises its features
    over 4 x 4 pixels there."""
    jm, pm, x = JR.RIFE(c=4), PR.RIFE(c=4), _clip((2, 64, 64, 6))
    v = variables(jm, x)
    pm = carry(v, pm)
    with torch.no_grad():
        close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x),
                                                train=False))
        pm.train()
        got = pm(torch.from_numpy(x))
    want, _ = jm.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    assert len(got) == len(want) == 5
    # batch statistics give flows of many pixels: a flow's f32 rounding
    # moves its sample by that much times the image's slope (1e-4)
    for g, w in zip(got, want):
        close(g, w, 1e-4)


@pytest.mark.parametrize("kind,extra,x", [
    ("sr3d", {"nf": 4}, (1, 5, 8, 8, 3)),
    ("edvr", {"nf": 16, "deformable_groups": 4, "num_extract_block": 1,
              "num_reconstruct_block": 1}, (1, 5, 16, 16, 3)),
    ("rife", {"c": 4}, (1, 32, 32, 6)),
    ("evsrgan", {"nf": 8, "nb": 1, "gc": 4}, (1, 3, 8, 8, 3)),
    ("sofvsr", {"channels": 8, "sr_nf": 8, "sr_nb": 1}, (1, 3, 8, 8, 3))])
def test_define_g_builds_each_video_net(kind, extra, x):
    """The parsed config equals the JAX package's (defaults, aliases:
    EDVR's ``nf`` and ``scale``, EVSRGAN's Conv3D), and the net it builds
    runs in eval mode to the expected shape."""
    spec = {"type": kind, **extra}
    cfg = get_network_G_config(dict(spec), 4)
    want = jax_g_config(dict(spec), 4)
    assert cfg == want
    net = define_G({"network_G": cfg})
    net.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(_clip(x)))
    out = out[3] if isinstance(out, tuple) else out
    px = x[-2] if kind == "rife" else x[-2] * 4
    assert out.shape == (1, px, px, 3) and torch.isfinite(out).all()
