"""Optimizer factory (port of shifu_tpu/train/optimizers.py).

Every rule follows optax's update, as the JAX package builds it, not
`torch.optim`'s defaults.  Where the two differ the port writes the rule out:

- rmsprop: optax decays by 0.9 and puts eps 1e-8 inside the square root
  (torch: alpha 0.99, eps outside);
- adagrad: optax starts the accumulator at 0.1, eps 1e-7 inside the square
  root (torch: 0 and 1e-10 outside);
- adamw: optax adds weight_decay * p to the Adam direction before the
  learning-rate scale;
- adadelta: rho 0.95 and eps 1e-8, TF 1.4's defaults that the reference
  ran with (optax's own defaults are 0.9 and 1e-6).

A transformation works on lists of tensors: `init(params)` makes its state
and `update(grads, state, params)` returns (updates, new state); `chain`
composes them as `optax.chain` does, and `MultiSteps` accumulates
`accumulate_steps` micro-batch gradients (their running mean) before one
inner update.  `Optimizer.step` adds the updates to the parameters in place
(the port mutates its parameters where optax returns new ones).  Step
counters are Python ints, so no update waits on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..config.schema import ConfigError, OptimizerConfig

# TF 1.4 AdadeltaOptimizer defaults (the reference passes only the rate)
_TF_ADADELTA_RHO = 0.95
_TF_ADADELTA_EPS = 1e-8

Tensors = list[torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


# -- learning-rate schedules (optax's formulas, in float32 like jnp) -------

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                             / f32(decay_steps)))
        return float(f32(init_value) * ((f32(1) - f32(alpha)) * cosine
                                        + f32(alpha)))
    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    f32 = np.float32

    def schedule(count: int) -> float:
        if count <= 0:
            return float(f32(init_value))
        p = f32(count) / f32(transition_steps)
        return float(f32(init_value) * np.power(f32(decay_rate), p))
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(max(count, 0), transition_steps))
        frac = f32(1) - c / f32(transition_steps)
        return float((f32(init_value) - f32(end_value)) * frac
                     + f32(end_value))
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else cos(count - warmup_steps))


def learning_rate(cfg: OptimizerConfig) -> ScalarOrSchedule:
    """The rate or schedule of OptimizerConfig.schedule, counted in
    optimizer steps."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        return lr
    if cfg.schedule == "cosine":
        return cosine_decay_schedule(lr, cfg.decay_steps,
                                     alpha=cfg.end_lr_factor)
    if cfg.schedule == "exponential":
        return exponential_decay(lr, cfg.decay_steps, cfg.decay_rate)
    if cfg.schedule == "warmup_cosine":
        return warmup_cosine_decay_schedule(
            0.0, lr, cfg.warmup_steps, cfg.decay_steps,
            end_value=lr * cfg.end_lr_factor)
    raise ConfigError(f"unknown schedule {cfg.schedule!r}")


# -- transformations ---------------------------------------------------------

def _moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int
            ) -> torch.Tensor:
    """optax.tree.update_moment: (1 - decay) * g**order + decay * t."""
    return (1 - decay) * (g if order == 1 else g * g) + decay * t


class Transform:
    def init(self, params: Tensors) -> Any:
        return None

    def update(self, grads: Tensors, state: Any, params: Tensors
               ) -> tuple[Tensors, Any]:
        raise NotImplementedError


class ScaleByLearningRate(Transform):
    """-lr * updates, lr a constant or a schedule of the update count."""

    def __init__(self, lr: ScalarOrSchedule):
        self.lr = lr

    def init(self, params):
        return 0

    def update(self, grads, count, params):
        step = -(self.lr(count) if callable(self.lr) else self.lr)
        return [g * step for g in grads], count + 1


class ScaleByAdadelta(Transform):
    def __init__(self, rho: float, eps: float):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return ([torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads, state, params):
        e_g_prev, e_x_prev = state
        e_g = [_moment(g, t, self.rho, 2) for g, t in zip(grads, e_g_prev)]
        ups = [torch.sqrt(ex + self.eps) / torch.sqrt(eg + self.eps) * g
               for g, eg, ex in zip(grads, e_g, e_x_prev)]
        e_x = [_moment(u, t, self.rho, 2) for u, t in zip(ups, e_x_prev)]
        return ups, (e_g, e_x)


class ScaleByAdam(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return (0, [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads, state, params):
        count, mu, nu = state
        mu = [_moment(g, m, self.b1, 1) for g, m in zip(grads, mu)]
        nu = [_moment(g, v, self.b2, 2) for g, v in zip(grads, nu)]
        count += 1
        c1 = 1 - float(np.float32(self.b1) ** np.float32(count))
        c2 = 1 - float(np.float32(self.b2) ** np.float32(count))
        ups = [(m / c1) / (torch.sqrt(v / c2) + self.eps)
               for m, v in zip(mu, nu)]
        return ups, (count, mu, nu)


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, grads, state, params):
        return ([g + self.weight_decay * p.detach()
                 for g, p in zip(grads, params)], state)


class Trace(Transform):
    """Momentum: t = g + decay * t; the update is t."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads, trace, params):
        trace = [g + self.decay * t for g, t in zip(grads, trace)]
        return list(trace), trace


class ScaleByRms(Transform):
    """optax.scale_by_rms with eps inside the square root."""

    def __init__(self, decay: float = 0.9, eps: float = 1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads, nu, params):
        nu = [_moment(g, n, self.decay, 2) for g, n in zip(grads, nu)]
        return [torch.rsqrt(n + self.eps) * g for g, n in zip(grads, nu)], nu


class ScaleByRss(Transform):
    """optax.scale_by_rss (adagrad): accumulator from 0.1, eps 1e-7."""

    def __init__(self, initial: float = 0.1, eps: float = 1e-7):
        self.initial, self.eps = initial, eps

    def init(self, params):
        return [torch.full_like(p, self.initial) for p in params]

    def update(self, grads, acc, params):
        acc = [g * g + t for g, t in zip(grads, acc)]
        inv = [torch.where(t > 0, torch.rsqrt(t + self.eps),
                           torch.zeros_like(t)) for t in acc]
        return [i * g for i, g in zip(inv, grads)], acc


class ClipByGlobalNorm(Transform):
    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, grads, state, params):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < self.max_norm
        return ([torch.where(trigger, g, (g / g_norm) * self.max_norm)
                 for g in grads], state)


class Chain(Transform):
    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, grads, states, params):
        new_states = []
        for t, s in zip(self.transforms, states):
            grads, s = t.update(grads, s, params)
            new_states.append(s)
        return grads, new_states


class MultiSteps(Transform):
    """optax.MultiSteps with the gradient mean: accumulate k micro-batch
    gradients, then one inner update; the other k-1 updates are zeros.
    The inner update runs only when it is committed (optax computes it
    every call and keeps it only on the k-th, the same result)."""

    def __init__(self, inner: Transform, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params):
        return {"mini_step": 0, "inner": self.inner.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    def update(self, grads, state, params):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc"])]
        if n < self.k - 1:
            return ([torch.zeros_like(g) for g in grads],
                    {"mini_step": n + 1, "inner": state["inner"],
                     "acc": acc})
        ups, inner = self.inner.update(acc, state["inner"], params)
        return ups, {"mini_step": 0, "inner": inner,
                     "acc": [torch.zeros_like(a) for a in acc]}


def build_transform(cfg: OptimizerConfig) -> Transform:
    """The transformation optax would build for `cfg` (the JAX package's
    `build_optimizer`)."""
    name = cfg.name.lower()
    scale = ScaleByLearningRate(learning_rate(cfg))
    if name == "adadelta":
        tx: Transform = Chain(ScaleByAdadelta(_TF_ADADELTA_RHO,
                                              _TF_ADADELTA_EPS), scale)
    elif name == "adam":
        tx = Chain(ScaleByAdam(), scale)
    elif name == "adamw":
        tx = Chain(ScaleByAdam(), AddDecayedWeights(cfg.weight_decay), scale)
    elif name in ("sgd", "gradientdescent"):
        tx = scale
    elif name == "momentum":
        tx = Chain(Trace(cfg.momentum), scale)
    elif name == "rmsprop":
        tx = Chain(ScaleByRms(), scale)
    elif name == "adagrad":
        tx = Chain(ScaleByRss(), scale)
    else:
        raise ConfigError(f"unknown optimizer {cfg.name!r}")
    if cfg.grad_clip_norm > 0:
        tx = Chain(ClipByGlobalNorm(cfg.grad_clip_norm), tx)
    if cfg.accumulate_steps > 1:
        tx = MultiSteps(tx, cfg.accumulate_steps)
    return tx


class Optimizer:
    """A transformation bound to a parameter list and its state."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 cfg: OptimizerConfig):
        self.params = list(params)
        self.tx = build_transform(cfg)
        with torch.no_grad():
            self.state = self.tx.init([p.detach() for p in self.params])

    @torch.no_grad()
    def step(self, grads: Optional[Tensors] = None) -> None:
        """Apply one update from `grads` (default: each parameter's .grad)."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        ups, self.state = self.tx.update(
            list(grads), self.state, [p.detach() for p in self.params])
        for p, u in zip(self.params, ups):
            p.add_(u)
