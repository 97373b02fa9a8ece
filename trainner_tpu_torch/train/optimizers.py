"""Optimizers: counterpart of ``trainner_tpu/train/optimizers.py``
(``centralize_gradients:32``, ``_adamp_project:58``, ``scale_by_adamp:
111``, ``scale_by_sgdp:151``, ``lookahead:187``, ``scale_by_radam:223``,
``Optimizer:278``, ``build_optimizer:299``, ``_MadgradOptimizer:349``,
``_RangerOptimizer:406``), with the learning rate given at update time.

The update rules are those of the optax chains the JAX package builds:

* adam: ``scale_by_adam`` (bias-corrected m / (sqrt(v) + eps), eps 1e-8:
  torch's Adam formula), then ``add_decayed_weights``: the weight decay is
  *decoupled*, u = adam_direction + wd * p, so a non-zero ``weight_decay``
  is AdamW's rule, not Adam's L2 penalty;
* sgd: ``trace(decay=momentum)``: t = g + momentum * t (torch's SGD with
  dampening 0), then the same decoupled decay;
* rmsprop: optax's ``scale_by_rms(decay=0.99)``: nu = 0.99 nu + 0.01 g^2
  from nu = 0, u = g * rsqrt(nu + eps) (eps inside the root, unlike
  ``torch.optim.RMSprop``), then the decoupled decay;
* adamp / sgdp: Adam's direction (or SGD's momentum buffer) with AdamP's
  projection: where the gradient is nearly orthogonal to a weight of two
  or more axes, seen per row of its first axis (else as one row), the
  direction's component along the weight is removed and the weight decay,
  added inside, shrinks by ``wd_ratio``;
* ranger: gradient centralisation (with ``use_gc``), RAdam's rectified
  direction (beta1 0.9 becomes 0.95, eps 1e-5), the decoupled decay, then
  Lookahead on the final deltas: every k-th step the parameter becomes
  p + (slow_new - p), slow_new = slow + alpha (p + delta - slow);
* madgrad: MADGRAD's dual averaging, where the learning rate enters the
  state; the parameter becomes p + (p_new - p);
* p <- p - lr * u for the others.

They are a few lines of ``torch._foreach`` tensor code each, so that the
state is the optax state leaf for leaf and can be carried across from a
JAX run (``state_dict`` names each list as optax does: ``mu``, ``nu``,
``trace``, ``momentum``, ``slow``, ``grad_sum_sq``, ``s``, ``x0``).

A step reads nothing from the host that changes from step to step, so a
CUDA graph can replay it: the learning rate is a 0-d f32 tensor, the
counts int32 tensors on the parameters' device, every branch of the
rules (RAdam's rectification, Lookahead's sync, AdamP's projection) a
``torch.where`` over device tensors. Adam's bias corrections 1 -
beta**count are f32 device scalars computed as XLA computes optax's ``1 -
decay**count`` (binary exponentiation in f32: beta, beta^2, beta^4, ...
each rounded to f32, the factors of count's set bits multiplied in from
the lowest bit up); AdamP's and RAdam's raise beta to the count made a
float, as the JAX rules do. The state dict keeps the counts ints, as the
JAX format does; loads write into the state's tensors in place, so a graph
captured before a load stays valid.

AdamP's projection and gradient centralisation depend on a weight's
layout. ``views`` gives, per parameter, the permutation that takes the
port's tensor to the JAX package's layout of the same weight (a conv's
OIHW to HWIO, a linear's (out, in) to (in, out)); the rules run there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_COUNT_BITS = 31  # an int32 count

# the state lists of each optimizer, by the names of its optax state
_LISTS = {"adam": ("mu", "nu"), "sgd": ("trace",), "rmsprop": ("nu",),
          "adamp": ("mu", "nu"), "sgdp": ("momentum",),
          "ranger": ("mu", "nu", "slow"),
          "madgrad": ("grad_sum_sq", "s", "x0")}
# the JAX rules' defaults, which its trainer never overrides: AdamP's
# projection threshold and decay factor, Lookahead's period and step
ADAMP_DELTA = 0.1
WD_RATIO = {"adamp": 0.1, "sgdp": 1.0}
LOOKAHEAD_K, LOOKAHEAD_ALPHA = 6, 0.5



def _power_table(beta: float) -> np.ndarray:
    """beta^(2^i) for i < 31, each square rounded to f32."""
    out = np.empty(_COUNT_BITS, np.float32)
    sq = np.float32(beta)
    for i in range(_COUNT_BITS):
        out[i] = sq
        sq = np.float32(sq * sq)
    return out


def jax_view(p: torch.Tensor) -> Tuple[int, ...]:
    """The permutation from a port parameter's layout to the JAX
    package's: OIHW -> HWIO for a 4-d conv weight, (out, in) -> (in, out)
    for a 2-d linear weight, none for the others."""
    if p.dim() == 4:
        return (2, 3, 1, 0)
    if p.dim() == 2:
        return (1, 0)
    return tuple(range(p.dim()))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The cube root of a non-negative tensor, from f64 rounded once to
    its type: the nearest value, which ``x ** (1/3)`` in f32 is not (nor,
    by an ulp or a few, XLA's ``jnp.cbrt``)."""
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


class Optimizer:
    """Holds the parameters it updates and their state. ``step(lr)`` applies
    one update from the parameters' ``.grad``; a parameter without a
    gradient is left alone (a frozen one has a zero gradient and moves on
    its moments, as in optax)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], name: str,
                 beta1: float, beta2: float, eps: float, weight_decay: float,
                 momentum: float, views: Optional[Sequence[tuple]] = None,
                 use_gc: bool = False):
        self.params: List[torch.nn.Parameter] = list(params)
        self.name = name
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.use_gc = use_gc
        self.views = [tuple(v) for v in views] if views is not None \
            else [tuple(range(p.dim())) for p in self.params]
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.la_count = torch.zeros((), dtype=torch.int32, device=device)
        # the state's lists by their optax names ("momentum" is SGDP's
        # buffer here, the float of that name an attribute)
        self.moments: Dict[str, List[torch.Tensor]] = {
            key: [p.detach().clone() if key in ("slow", "x0")
                  else torch.zeros_like(p) for p in self.params]
            for key in _LISTS[name]}
        if name == "adam":
            # the bias corrections' factors beta^(2^i), made once: a copy
            # from the host inside a capture would wait for the card
            self._powers = torch.from_numpy(np.stack(
                [_power_table(beta1), _power_table(beta2)], 1)).to(device)

    @property
    def lists(self) -> Tuple[str, ...]:
        return _LISTS[self.name]

    def __getattr__(self, key: str):
        # opt.mu, opt.nu, ...: the lists (not "momentum", the float)
        moments = self.__dict__.get("moments", {})
        if key in moments and key != "momentum":
            return moments[key]
        raise AttributeError(key)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _corrections(self):
        """(1 - beta1**count, 1 - beta2**count) as f32 device scalars."""
        shifts = torch.arange(_COUNT_BITS, dtype=torch.int32,
                              device=self.count.device)
        bits = ((self.count >> shifts) & 1).bool()[:, None]
        factors = torch.where(bits, self._powers,
                              torch.ones_like(self._powers))
        acc = factors[0]
        for i in range(1, _COUNT_BITS):
            acc = acc * factors[i]
        c = 1.0 - acc
        return c[0], c[1]

    def _f32(self, value: float) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32,
                          device=self.count.device)

    @torch.no_grad()
    def step(self, lr: Union[torch.Tensor, float]) -> None:
        """One update with learning rate ``lr`` (a 0-d f32 tensor on the
        parameters' device; a float is made into one)."""
        idx = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not idx:
            return
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32,
                            device=self.count.device)
        params = [self.params[i] for i in idx]
        grads = [self.params[i].grad.float() for i in idx]
        views = [self.views[i] for i in idx]
        state = {k: [self.moments[k][i] for i in idx] for k in self.lists}
        if self.name == "madgrad":
            self._madgrad(params, grads, state, lr)
            self.count.add_(1)
            return
        self.count.add_(1)
        update = getattr(self, f"_{self.name}")(params, grads, views, state)
        if self.weight_decay and self.name in ("adam", "sgd", "rmsprop",
                                               "ranger"):
            torch._foreach_add_(update, torch._foreach_mul(
                params, self.weight_decay))
        if self.name == "ranger":
            self._lookahead(params, update, state["slow"], lr)
            return
        # p - lr * u, rounded as optax's p + (-lr * u)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)

    # -- the rules: each returns the direction u of p <- p - lr u ---------
    def _adam(self, params, grads, views, state):
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, grads, alpha=1 - self.beta1)
        torch._foreach_mul_(nu, self.beta2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.beta2)
        c1, c2 = self._corrections()
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, c1)
        torch._foreach_div_(update, denom)
        return update

    def _sgd(self, params, grads, views, state):
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        return [t.clone() for t in trace]

    def _rmsprop(self, params, grads, views, state):
        nu = state["nu"]
        # (1 - decay) g^2 + decay nu, as optax's update_moment_per_elem_norm
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - 0.99)
        torch._foreach_mul_(nu, 0.99)
        torch._foreach_add_(nu, sq)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, grads)

    def _adamp(self, params, grads, views, state):
        mu, nu = state["mu"], state["nu"]
        t = self.count.float()
        b1c = 1 - torch.pow(self._f32(self.beta1), t)
        b2c = 1 - torch.pow(self._f32(self.beta2), t)
        # b m + (1 - b) g, each product rounded, as the JAX rule writes it
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.beta1))
        torch._foreach_mul_(nu, self.beta2)
        g2 = torch._foreach_mul(grads, 1 - self.beta2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_add_(nu, g2)
        denom = torch._foreach_div(nu, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, b1c)
        torch._foreach_div_(step, denom)
        return self._project(params, grads, views, step)

    def _sgdp(self, params, grads, views, state):
        buf = state["momentum"]
        torch._foreach_mul_(buf, self.momentum)
        torch._foreach_add_(buf, grads)
        return self._project(params, grads, views, [b.clone() for b in buf])

    def _project(self, params, grads, views, step):
        """AdamP's projection of each direction of a weight of two or more
        axes, in its JAX layout, with the weight decay added inside
        (decay * wd_scale * p); parameters of one shape and layout are
        projected together."""
        step = list(step)
        groups: Dict[tuple, List[int]] = {}
        for i, (p, v) in enumerate(zip(params, views)):
            if p.dim() >= 2:
                groups.setdefault((tuple(p.shape), v), []).append(i)
        wd_scale: List[Optional[torch.Tensor]] = [None] * len(params)
        for (shape, view), members in groups.items():
            inv = tuple(int(j) for j in np.argsort(view))
            rows = shape[view[0]]

            def stacked(ts, view=view, rows=rows, members=members):
                return torch.stack([ts[i].permute(view).reshape(rows, -1)
                                    for i in members])
            p, g, d = stacked(params), stacked(grads), stacked(step)
            out, scale = _adamp_project(p, g, d, WD_RATIO[self.name],
                                        self.eps)
            jshape = tuple(shape[j] for j in view)
            for k, i in enumerate(members):
                step[i] = out[k].reshape(jshape).permute(inv)
                wd_scale[i] = scale[k]
        if self.weight_decay:
            for i, p in enumerate(params):
                s = (self.weight_decay if wd_scale[i] is None
                     else self.weight_decay * wd_scale[i])
                step[i] = step[i] + s * p
        return step

    def _ranger(self, params, grads, views, state):
        if self.use_gc:
            grads = [_centralize(g, v) for g, v in zip(grads, views)]
        mu, nu = state["mu"], state["nu"]
        b1 = self.beta1 if self.beta1 != 0.9 else 0.95
        b2, eps = self.beta2, 1e-5
        t = self.count.float()
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        g2 = torch._foreach_mul(grads, 1 - b2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_add_(nu, g2)
        b2t = torch.pow(self._f32(b2), t)
        n_sma_max = 2.0 / (1 - b2) - 1
        # python floats meet f32 tensors as f32 values, as JAX's weak
        # types do: (n_sma_max - 4) * (n_sma_max - 2) is a host product
        n_sma = n_sma_max - 2 * t * b2t / (1 - b2t)
        num = (n_sma - 4) * (n_sma - 2) * n_sma_max
        den = torch.clamp_min(
            (n_sma_max - 4) * (n_sma_max - 2) * n_sma, 1e-12)
        rect = torch.sqrt(num / den)
        use_var = n_sma >= 5.0
        b1c = 1 - torch.pow(self._f32(b1), t)
        sgd_step = torch._foreach_div(mu, b1c)
        denom = torch._foreach_div(nu, 1 - b2t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        var_step = torch._foreach_mul(sgd_step, rect)
        torch._foreach_div_(var_step, denom)
        return [torch.where(use_var, a, b)
                for a, b in zip(var_step, sgd_step)]

    def _lookahead(self, params, update, slow, lr):
        """u' = -lr u; every k-th call the parameter goes to the slow
        weights' interpolation, p + (slow_new - p)."""
        self.la_count.add_(1)
        sync = torch.remainder(self.la_count, LOOKAHEAD_K) == 0
        neg = -lr
        delta = [neg * u for u in update]
        fast = torch._foreach_add(params, delta)
        slow_new = [s + LOOKAHEAD_ALPHA * (f - s)
                    for s, f in zip(slow, fast)]
        final = [torch.where(sync, sn - p, d)
                 for sn, p, d in zip(slow_new, params, delta)]
        torch._foreach_copy_(slow, [torch.where(sync, sn, s)
                                    for sn, s in zip(slow_new, slow)])
        torch._foreach_add_(params, final)

    def _madgrad(self, params, grads, state, lr):
        gss, s, x0 = state["grad_sum_sq"], state["s"], state["x0"]
        lamb = (lr + self.eps) * torch.sqrt(self.count.float() + 1.0)
        mom, eps, wd = self.momentum, self.eps, self.weight_decay
        ck = 1.0 - mom
        if wd:
            grads = [g + wd * p for g, p in zip(grads, params)]
        if mom == 0.0:
            x0 = [p + si / (_cbrt(gi) + eps)
                  for p, si, gi in zip(params, s, gss)]
        lg = torch._foreach_mul(grads, lamb)
        torch._foreach_add_(gss, torch._foreach_mul(lg, grads))
        torch._foreach_add_(s, lg)
        for p, gi, si, xi in zip(params, gss, s, x0):
            z = xi - si / (_cbrt(gi) + eps)
            new = z if mom == 0.0 else (1.0 - ck) * p + ck * z
            p.add_(new - p)

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict:
        state = {"count": int(self.count)}
        if self.name == "ranger":
            state["la_count"] = int(self.la_count)
        for key in self.lists:
            state[key] = [t.clone() for t in self.moments[key]]
        return state

    def load_state_dict(self, state: Dict) -> None:
        """In place: the counts and the lists keep their storage. Lists
        the state does not carry are left as they are."""
        self.count.fill_(int(state.get("count", 0)))
        if "la_count" in state:
            self.la_count.fill_(int(state["la_count"]))
        for key in self.lists:
            if key in state:
                for mine, theirs in zip(self.moments[key], state[key]):
                    mine.copy_(theirs)


def _centralize(g: torch.Tensor, view: tuple) -> torch.Tensor:
    """g less its mean over every axis but the first of its JAX layout."""
    if g.dim() <= 1:
        return g
    axes = tuple(d for d in range(g.dim()) if d != view[0])
    return g - g.mean(axes, keepdim=True)


def _adamp_project(p, g, d, wd_ratio: float, eps: float):
    """``_adamp_project`` on N weights at once, each (R, C) in the channel
    view of its JAX layout: the projected directions and each weight's
    decay scale (wd_ratio where the projection fired, else 1)."""
    def norm(x):
        return torch.sqrt((x * x).sum(-1))

    def in_view(pv, gv, dv):
        cos = (gv * pv).sum(-1).abs() / ((norm(gv) + eps)
                                         * (norm(pv) + eps))
        # delta / sqrt(C) in f32, as the JAX rule computes it
        thresh = float(np.float32(ADAMP_DELTA) / np.sqrt(np.float32(
            pv.shape[-1])))
        cond = cos.amax(-1) < thresh
        expand = pv / (norm(pv)[..., None] + eps)
        proj = dv - expand * (dv * expand).sum(-1, keepdim=True)
        return cond, proj

    n = p.shape[0]
    c_cond, c_proj = in_view(p, g, d)
    l_cond, l_proj = in_view(p.reshape(n, 1, -1), g.reshape(n, 1, -1),
                             d.reshape(n, 1, -1))
    l_proj = l_proj.reshape(d.shape)
    c3, l3 = c_cond[:, None, None], l_cond[:, None, None]
    out = torch.where(c3, c_proj, torch.where(l3, l_proj, d))
    fired = c_cond | l_cond
    scale = torch.where(fired, torch.full_like(fired, wd_ratio,
                                               dtype=p.dtype),
                        torch.ones_like(fired, dtype=p.dtype))
    return out, scale


NAMES = ("adam", "adamw", "sgd", "rmsprop", "adamp", "sgdp", "ranger",
         "madgrad")


def build_optimizer(params: Sequence[torch.nn.Parameter],
                    name: str = "adam", *, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0, momentum: float = 0.9,
                    views: Optional[Sequence[tuple]] = None,
                    use_gc: bool = False) -> Optimizer:
    """String -> Optimizer over ``params``, with the JAX package's
    ``build_optimizer`` defaults (madgrad too takes its eps, 1e-8 by
    default, from here). ``views``: per parameter, the permutation to its
    JAX layout (``jax_view``), for AdamP's projection and gradient
    centralisation; by default the layouts are taken as equal."""
    name = (name or "adam").lower()
    if name == "adamw":
        name = "adam"
    if name not in _LISTS:
        raise NotImplementedError(f"optimizer [{name}] not recognized")
    return Optimizer(params, name, beta1, beta2, eps, weight_decay,
                     momentum, views=views, use_gc=use_gc)
