"""The port's device augmentation against the JAX package's.

`augment_batch_from_draws` is handed the exact draws
`wireframe_tpu.data.augment.augment_batch` makes from its key (same split
order), so the two must agree to f32 rounding of the 3x3 map (1e-6).
Jitter validity is `any(x != 0)` over the RAW row, as in the JAX code.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.data.augment import augment_batch as jax_augment_batch
from wireframe_tpu_torch.data.augment import (
    augment_batch,
    augment_batch_from_draws,
)


def _jax_draws(key, b, n, rot_degrees, scale_range):
    k_fx, k_fy, k_rot, k_jit, k_scale = jax.random.split(key, 5)
    rot = rot_degrees * jnp.pi / 180.0
    return {
        "flip_x": jax.random.bernoulli(k_fx, 0.5, (b,)),
        "flip_y": jax.random.bernoulli(k_fy, 0.5, (b,)),
        "angle": jax.random.uniform(k_rot, (b,), minval=-rot, maxval=rot),
        "noise": jax.random.normal(k_jit, (b, n, 3)),
        "scale": jax.random.uniform(k_scale, (b, 1, 1),
                                    minval=1.0 - scale_range,
                                    maxval=1.0 + scale_range),
    }


def _batch(seed, b=4, n=32, v=6):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(b, n, 8)).astype(np.float32)
    pc[0, 20:] = 0.0                     # padding rows
    pc[1, 3, :3] = 0.0                   # XYZ zero, colour not: valid
    tv = rng.normal(size=(b, v, 3)).astype(np.float32)
    tv[:, 4:] = 0.0
    return pc, tv


@pytest.mark.parametrize("rot,jitter,scale", [(5.0, 0.0, 0.0),
                                              (5.0, 0.005, 0.1),
                                              (30.0, 0.05, 0.0)])
def test_augment_matches_jax_given_its_draws(rot, jitter, scale):
    pc, tv = _batch(0)
    key = jax.random.PRNGKey(3)
    want_pc, want_tv = jax_augment_batch(
        key, jnp.asarray(pc), jnp.asarray(tv), rot_degrees=rot,
        jitter_std=jitter, scale_range=scale)
    d = {k: torch.from_numpy(np.array(v))
         for k, v in _jax_draws(key, 4, 32, rot, scale).items()}
    got_pc, got_tv = augment_batch_from_draws(
        torch.from_numpy(pc), torch.from_numpy(tv), d["flip_x"], d["flip_y"],
        d["angle"], noise=d["noise"] if jitter > 0 else None,
        scale=d["scale"] if scale > 0 else None, jitter_std=jitter)
    np.testing.assert_allclose(got_pc.numpy(), np.asarray(want_pc),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_tv.numpy(), np.asarray(want_tv),
                               rtol=1e-6, atol=1e-6)
    # Padding rows and padded vertex slots stay exactly zero.
    assert np.all(got_pc.numpy()[0, 20:] == 0.0)
    assert np.all(got_tv.numpy()[:, 4:] == 0.0)


def test_generator_draws_are_reproducible_and_in_range():
    pc, tv = _batch(1)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        outs.append(augment_batch(g, torch.from_numpy(pc),
                                  torch.from_numpy(tv), rot_degrees=5.0,
                                  jitter_std=0.01, scale_range=0.1))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    # Flips, a +-5 degree rotation and a scale in [0.9, 1.1] keep each
    # vertex's distance from the z axis within the scale range.
    r_in = np.linalg.norm(tv[..., :2], axis=-1)
    r_out = np.linalg.norm(outs[0][1].numpy()[..., :2], axis=-1)
    live = r_in > 0
    ratio = r_out[live] / r_in[live]
    assert np.all(ratio > 0.9 - 1e-5) and np.all(ratio < 1.1 + 1e-5)
    # Non-XYZ channels are untouched.
    np.testing.assert_array_equal(outs[0][0].numpy()[..., 3:], pc[..., 3:])
    assert math.isfinite(float(outs[0][0].abs().max()))
