"""K1 and the encoder module of the port against the JAX package.

The port's plain K1 (`fused_point_encoder_plain`, what the wrapper runs
for CPU tensors) is held against the JAX Pallas kernel run in interpret
mode, as tests/test_pallas_encoder.py runs it, on the same numpy inputs
and weights.  Tolerances: f32 compute agrees to float noise (rtol 1e-5,
atol 1e-5); bf16 compute rounds activations at the same places with
f32 accumulation in both, so only summation order differs and the odd
bf16 rounding flips (rtol 2e-2, atol 2e-3, the JAX package's own kernel
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.models.encoder import FusionMLP as JaxFusion
from wireframe_tpu.models.encoder import PointNetEncoder as JaxEncoder
from wireframe_tpu.ops import masked_pool as jax_pool
from wireframe_tpu.ops.pallas_encoder import fused_point_encoder as jax_k1
from wireframe_tpu_torch.bridge import params_from_flax
from wireframe_tpu_torch.models.encoder import FusionMLP, PointNetEncoder
from wireframe_tpu_torch.ops import masked_pool
from wireframe_tpu_torch.ops._launch import launch_counts
from wireframe_tpu_torch.ops.fused_encoder import (
    fused_point_encoder,
    fused_point_encoder_plain,
    point_encoder_reference,
)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}
KEYS = ("masked_mean", "masked_max", "mean", "max", "kv_features")


def _params(rng, d, dims, c):
    """Nonzero biases and LayerNorm affine terms: padding rows then carry
    real features into the unmasked pools."""
    prev, sp = d, []
    for h in dims:
        sp.append(((rng.normal(size=(prev, h)) * 0.3).astype(np.float32),
                   (rng.normal(size=h) * 0.1).astype(np.float32),
                   (1 + rng.normal(size=h) * 0.1).astype(np.float32),
                   (rng.normal(size=h) * 0.1).astype(np.float32)))
        prev = h
    fw = (rng.normal(size=(prev, c)) * 0.2).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    return sp, fw, fb


def _cloud(rng, b, n, d=8):
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    x[0, 40:] = 0.0        # padding tail
    x[1, 8:12] = 0.0       # one fully-invalid kv window mid-cloud
    x[-1] = 0.0            # an all-padding sample
    return x


def _both(x, sp, fw, fb, dtype, **kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jax_k1(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in sp],
                  jnp.asarray(fw), jnp.asarray(fb), interpret=True,
                  compute_dtype=jdt, **kw)
    tsp = [tuple(map(torch.from_numpy, p)) for p in sp]
    got = fused_point_encoder_plain(torch.from_numpy(x), tsp,
                                    torch.from_numpy(fw),
                                    torch.from_numpy(fb), compute_dtype=tdt,
                                    **kw)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_pallas_interpret(rng, dtype):
    sp, fw, fb = _params(rng, 8, (32, 64), 32)
    x = _cloud(rng, 3, 64)
    got, want = _both(x, sp, fw, fb, dtype, tile=32, kv_pool=4,
                      return_point_features=True)
    for key in KEYS + ("point_features",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL[dtype])
    # The all-padding sample pools to exactly zero, and the empty kv
    # window of sample 1 too; the unmasked pools still see padding rows.
    for key in ("masked_mean", "masked_max", "kv_features"):
        assert not got[key][-1].any(), key
    assert not got["kv_features"][1, 2].any()
    assert got["max"][-1].abs().max() > 0


def test_plain_k1_without_kv_pool(rng):
    sp, fw, fb = _params(rng, 8, (32,), 16)
    x = _cloud(rng, 3, 64)
    got, want = _both(x, sp, fw, fb, "float32", tile=64)
    assert "kv_features" not in got and "point_features" not in got
    for key in KEYS[:4]:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL["float32"])


def test_plain_k1_checks_tiling(rng):
    sp, fw, fb = _params(rng, 8, (32,), 16)
    tsp = [tuple(map(torch.from_numpy, p)) for p in sp]
    x = torch.zeros(1, 64, 8)
    with pytest.raises(ValueError):
        fused_point_encoder_plain(x, tsp, torch.from_numpy(fw),
                                  torch.from_numpy(fb), tile=48)
    with pytest.raises(ValueError):
        fused_point_encoder_plain(x, tsp, torch.from_numpy(fw),
                                  torch.from_numpy(fb), tile=32, kv_pool=8)


def test_wrapper_takes_plain_version_on_cpu_only(rng, monkeypatch):
    """A CPU tensor gets the plain version (no library loaded, no launch
    counted); any other non-CUDA device is refused."""
    from test_torch_chain_grad import no_kernel_library

    sp, fw, fb = _params(rng, 8, (32,), 16)
    tsp = [tuple(map(torch.from_numpy, p)) for p in sp]
    x = torch.from_numpy(_cloud(rng, 3, 64))
    no_kernel_library(monkeypatch)
    before = launch_counts()
    got = fused_point_encoder(x, tsp, torch.from_numpy(fw),
                              torch.from_numpy(fb), tile=32, kv_pool=4)
    want = fused_point_encoder_plain(x, tsp, torch.from_numpy(fw),
                                     torch.from_numpy(fb), tile=32,
                                     kv_pool=4)
    assert launch_counts() == before
    for key in KEYS:
        assert torch.equal(got[key], want[key])
    with pytest.raises(ValueError):
        fused_point_encoder(x.to("meta"), tsp, torch.from_numpy(fw),
                            torch.from_numpy(fb), tile=32)


def test_reference_chain_matches_jax(rng):
    from wireframe_tpu.ops.pallas_encoder import point_encoder_reference as jr

    sp, fw, fb = _params(rng, 8, (32, 64), 32)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    want = jr(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in sp],
              jnp.asarray(fw), jnp.asarray(fb), compute_dtype=jnp.float32)
    got = point_encoder_reference(
        torch.from_numpy(x), [tuple(map(torch.from_numpy, p)) for p in sp],
        torch.from_numpy(fw), torch.from_numpy(fb),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_chain_layer_norm_matches_pallas(rng, scale):
    """The chain's two-pass LayerNorm (eps 1e-6); at scale 1e-3 the
    variance is ~eps, so the eps matters."""
    from wireframe_tpu.ops.pallas_encoder import _ln as jax_ln
    from wireframe_tpu_torch.ops.fused_encoder import ln

    x = (rng.normal(size=(4, 24)) * scale + scale).astype(np.float32)
    g = rng.normal(size=24).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    np.testing.assert_allclose(
        ln(*map(torch.from_numpy, (x, g, b))).numpy(),
        np.asarray(jax_ln(*map(jnp.asarray, (x, g, b)))), **TOL["float32"])


def test_masked_pools_match_jax(rng):
    f = rng.normal(size=(3, 12, 5)).astype(np.float32)
    m = rng.uniform(size=(3, 12)) > 0.5
    m[2] = False
    x = rng.normal(size=(3, 12, 8)).astype(np.float32)
    x[0, :4] = 0.0
    tf, tm = torch.from_numpy(f), torch.from_numpy(m)
    np.testing.assert_array_equal(
        masked_pool.point_validity_mask(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pool.point_validity_mask(jnp.asarray(x))))
    np.testing.assert_allclose(
        masked_pool.masked_mean(tf, tm).numpy(),
        np.asarray(jax_pool.masked_mean(jnp.asarray(f), jnp.asarray(m))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        masked_pool.masked_max(tf, tm).numpy(),
        np.asarray(jax_pool.masked_max(jnp.asarray(f), jnp.asarray(m))))
    for window in (1, 4, 5):   # 5 pads N=12 up to 15 with invalid rows
        got, got_m = masked_pool.window_max_pool(tf, tm, window)
        want, want_m = jax_pool.window_max_pool(jnp.asarray(f),
                                                jnp.asarray(m), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_mlp_matches_flax(rng, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = rng.normal(size=(3, 32)).astype(np.float32)
    jm = JaxFusion(16, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    tm = FusionMLP(16, dtype=tdt)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    tol = TOL[dtype] if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("use_pallas,kv_pool,dtype", [
    (True, 4, "float32"), (False, 4, "float32"), (True, 0, "float32"),
    (True, 4, "bfloat16"),
])
def test_point_net_encoder_matches_flax(rng, use_pallas, kv_pool, dtype):
    """Same routing as the flax module: the kernel (interpret mode in
    JAX, the plain K1 in the port) or the plain chain, the in-kernel kv
    pool with its raw-input window mask, and the fusion MLP."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = _cloud(rng, 3, 64)
    kw = dict(input_dim=8, hidden_dims=(32, 64), output_dim=32,
              use_pallas=use_pallas, pallas_tile=32, kv_pool=kv_pool,
              point_features_for_kv=True)
    jm = JaxEncoder(dtype=jdt, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # Nonzero stage biases so padding rows are not zero after the chain.
    params = jax.tree_util.tree_map(np.asarray, params)
    params = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1
                  if k.endswith("_b") else v) for k, v in params.items()}
    g_want, pooled_want, pf_want = jm.apply({"params": params},
                                            jnp.asarray(x))
    tm = PointNetEncoder(dtype=tdt, **kw)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        g_got, pooled_got, pf_got = tm(torch.from_numpy(x))
    tol = TOL[dtype] if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), **tol)
    assert set(pooled_got) == set(pooled_want)
    for key in pooled_want:
        np.testing.assert_allclose(pooled_got[key].float().numpy(),
                                   np.asarray(pooled_want[key], np.float32),
                                   err_msg=key, **tol)
    assert (pf_got is None) == (pf_want is None)
    if pf_want is not None:
        np.testing.assert_allclose(pf_got.numpy(), np.asarray(pf_want), **tol)
