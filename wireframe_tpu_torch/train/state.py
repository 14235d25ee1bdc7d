"""Train state: the model's parameters, the optimizer moments and the EMA.

Port of `wireframe_tpu/train/state.py`.  The optimizer is the JAX
package's optax chain, applied in the same order with the same
arithmetic (torch.optim is not used: its clipping and decay differ):

1. `clip_by_global_norm(max_norm)`: g if ||g|| < max_norm, else
   g / ||g|| * max_norm (torch's clip_grad_norm_ divides by ||g|| + 1e-6);
2. `add_decayed_weights(wd)`: g + wd * p, coupled L2 decay (not AdamW);
3. `scale_by_adam`: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
   bias corrections with count + 1, update mu_hat / (sqrt(nu_hat) + eps);
4. the learning rate, -lr(count) * update, where the schedule is indexed
   by the number of updates already applied, so the first update of a
   warmup_cosine schedule uses lr(0) = 0;
then p + update, then the EMA ema = d * ema + (1 - d) * p.

The parameters are updated in place (the JAX state is immutable and
copied; in place saves a copy of every parameter per step).  The
learning rate is computed on the host from the step count the host keeps,
so a step needs no device -> host sync.  `train.flatten_optimizer`
(optax.flatten) changes no number, only the JAX state's layout, so the
port accepts it and runs the same update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

Schedule = Union[float, Callable[[int], float]]


def make_lr_schedule(cfg, steps_per_epoch: int = 1) -> Schedule:
    """Scalar LR schedule per cfg.train.lr_schedule: a float for
    "constant", else count -> lr with optax's warmup_cosine_decay_schedule
    arithmetic in float32."""
    t = cfg.train
    if t.lr_schedule == "constant":
        return t.learning_rate
    if t.lr_schedule != "warmup_cosine":
        raise ValueError(f"Unknown lr_schedule: {t.lr_schedule!r}")
    total = max(t.num_epochs * max(steps_per_epoch, 1), t.warmup_steps + 1)
    peak = np.float32(t.learning_rate)
    warmup = t.warmup_steps
    decay_steps = total - warmup
    alpha = np.float32(0.0 if t.learning_rate == 0.0
                       else (t.learning_rate * t.lr_min_ratio)
                       / t.learning_rate)

    def schedule(count: int) -> float:
        f32 = np.float32
        if count < warmup:
            # optax.linear_schedule(0, peak, warmup): polynomial, power 1.
            c = f32(min(max(count, 0), warmup))
            frac = f32(1) - c / f32(warmup)
            return float((f32(0) - peak) * frac + peak)
        c = f32(min(count - warmup, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                             / f32(decay_steps)))
        return float(peak * ((f32(1) - alpha) * cosine + alpha))

    return schedule


@dataclass
class TrainState:
    """The model (whose parameters are the params), Adam's moments by
    parameter name, the number of updates applied, and the EMA copy of the
    params (None when train.ema_decay == 0)."""

    model: nn.Module
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(cfg, model: nn.Module) -> TrainState:
    """Fresh optimizer state (zero moments, step 0) and, with
    train.ema_decay > 0, an EMA that starts as a copy of the params."""
    params = dict(model.named_parameters())
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if cfg.train.ema_decay > 0 else None)
    return TrainState(model=model, mu=zeros,
                      nu={k: v.clone() for k, v in zeros.items()},
                      ema_params=ema)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum over tensors of sum(x^2)), optax's global_norm."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Optimizer:
    """The optax chain of `wireframe_tpu/train/state.py:make_optimizer`."""

    def __init__(self, cfg, steps_per_epoch: int = 1):
        t = cfg.train
        self.max_norm = t.grad_clip_norm
        self.weight_decay = t.weight_decay
        self.b1, self.b2, self.eps = t.adam_b1, t.adam_b2, t.adam_eps
        self.ema_decay = t.ema_decay
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s) if isinstance(s, (int, float)) else s(count)

    @torch.no_grad()
    def apply(self, state: TrainState, grads: Dict[str, torch.Tensor],
              g_norm: Optional[torch.Tensor] = None) -> None:
        """One update of `state` in place from the unclipped `grads`
        (by parameter name).  `g_norm` is their global norm, when the
        caller already has it."""
        names = list(grads)
        params = state.params
        p = [params[k] for k in names]
        g = [grads[k].float() for k in names]
        if g_norm is None:
            g_norm = global_norm(g)
        # 1. clip_by_global_norm: select, not a factor of 1 (bit-exact).
        trigger = g_norm < self.max_norm
        g = [torch.where(trigger, t, (t / g_norm) * self.max_norm)
             for t in g]
        # 2. add_decayed_weights
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))
        # 3. scale_by_adam
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        new_mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                    torch._foreach_mul(mu, self.b1))
        new_nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul(nu, self.b2))
        count_inc = state.step + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count_inc))
        mu_hat = torch._foreach_div(new_mu, bc1)
        nu_hat = torch._foreach_div(new_nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        # 4. the learning rate, indexed by the updates already applied.
        upd = torch._foreach_mul(upd, -self.lr(state.step))
        torch._foreach_add_(p, upd)
        for k, m, n in zip(names, new_mu, new_nu):
            state.mu[k] = m
            state.nu[k] = n
        state.step = count_inc
        if state.ema_params is not None and self.ema_decay > 0:
            d = self.ema_decay
            ema = [state.ema_params[k] for k in names]
            new = torch._foreach_add(torch._foreach_mul(ema, d),
                                     torch._foreach_mul(p, 1.0 - d))
            for k, e in zip(names, new):
                state.ema_params[k] = e
