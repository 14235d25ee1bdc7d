"""The port's optimizer against the JAX package's optax chain.

`wireframe_tpu.train.state.make_optimizer` (clip_by_global_norm ->
add_decayed_weights -> scale_by_adam -> learning rate) and the port's
`Optimizer` get the same params and gradients, with the clip triggered
and not, at schedule step 0 (warmup_cosine: lr(0) = 0), inside the warmup
and at the end of the decay.  Both compute in f32; they differ in the
order of the global-norm sum (which scales every clipped gradient) and in
how the bias corrections are formed, a few ulps each, compounded over 12
steps: params, EMA and moments agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from wireframe_tpu.config import load_config as jax_load_config
from wireframe_tpu.train.state import (
    make_lr_schedule as jax_make_lr_schedule,
    make_optimizer,
)
from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.train.state import (
    Optimizer,
    TrainState,
    make_lr_schedule,
)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
OVERRIDES = ["train.lr_schedule=warmup_cosine", "train.warmup_steps=4",
             "train.num_epochs=10", "train.learning_rate=1e-2",
             "train.weight_decay=1e-3", "train.ema_decay=0.9"]


class _Holder(nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(torch.tensor(v)))


def _arrays(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_optimizer_matches_optax(grad_scale):
    jcfg = jax_load_config(None, OVERRIDES)
    cfg = load_config(None, OVERRIDES)
    tx = make_optimizer(jcfg)
    params = _arrays(0, 1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    model = _Holder(params)
    zeros = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state = TrainState(model=model, mu=dict(zeros),
                       nu={k: v.clone() for k, v in zeros.items()},
                       ema_params={k: torch.tensor(v)
                                   for k, v in params.items()})
    opt = Optimizer(cfg)
    jema = dict(jp)
    for step in range(12):          # warmup, decay, and past the end
        grads = _arrays(100 + step, grad_scale)
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        jema = {k: 0.9 * jema[k] + 0.1 * jp[k] for k in jp}
        opt.apply(state, {k: torch.from_numpy(v) for k, v in grads.items()})
        got = state.params
        for k in SHAPES:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(state.ema_params[k].numpy(),
                                       np.asarray(jema[k]), rtol=1e-5,
                                       atol=1e-7)
        adam = opt_state[2]
        assert int(adam.count) == state.step == step + 1
        for k in SHAPES:
            np.testing.assert_allclose(state.mu[k].numpy(),
                                       np.asarray(adam.mu[k]), rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(state.nu[k].numpy(),
                                       np.asarray(adam.nu[k]), rtol=1e-5,
                                       atol=1e-12)
        if step == 0:
            # lr(0) = 0: the first warmup update moves nothing.
            np.testing.assert_array_equal(got["a"].detach().numpy(),
                                          params["a"])


def test_schedule_matches_optax():
    jcfg = jax_load_config(None, OVERRIDES)
    cfg = load_config(None, OVERRIDES)
    for steps_per_epoch in (1, 3):
        want = jax_make_lr_schedule(jcfg, steps_per_epoch)
        got = make_lr_schedule(cfg, steps_per_epoch)
        for count in (0, 1, 3, 4, 5, 9, 10, 29, 30, 40):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6, atol=1e-12)
    const = load_config(None, ["train.lr_schedule=constant"])
    assert make_lr_schedule(const) == const.train.learning_rate
    with pytest.raises(ValueError, match="lr_schedule"):
        make_lr_schedule(load_config(None, ["train.lr_schedule=step"]))
