"""The 3xTF32 arithmetic of the f32 kernels, emulated on the CPU.

On the card the f32 encoder-chain kernels (K1, K2, K3, K5) multiply on
the tensor cores in TF32 (`csrc/hopper_gemm.cuh`'s 3xTF32 main loop):
each f32 operand x is split into hi = x rounded to TF32 (10 mantissa
bits, round to nearest, ties away: `cvt.rna.tf32.f32`) and lo = x - hi
(exact in f32) rounded to TF32 in turn, and a product sums lo(A) hi(B) +
hi(A) lo(B) + hi(A) hi(B) in f32, dropping lo(A) lo(B) (~2^-22 relative).
Here the same split and the same three products replace the plain
versions' f32 matmul (`dot`), and the chain's outputs and every
gradient, on seeded numpy inputs with the chain test's padded rows and
ties, are held against the JAX package's `make_differentiable_chain(
compute_dtype=float32, interpret=True)`: outputs within the JAX test's
f32 bound, rtol = atol = 1e-5; gradients within rtol = atol = 1e-4, ten
times inside the JAX test's own f32 gradient bound (rtol 1e-3, atol
2e-4).  (At rtol = atol = 1e-5 the gradients of the plain f32 product
itself reach 0.85 of the bound at these shapes, the emulation 1.8: the
sum is ordered differently, and the LayerNorm backward amplifies it.)
K1's plain version is held to the Pallas encoder the same way.  One TF32
pass (hi(A) hi(B) alone) misses both bounds by orders of magnitude: the
split is what makes the tensor cores f32-accurate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chain_grad import (
    FLAVOURS,
    _cloud,
    _params,
    _run_jax,
    _run_torch,
)
from wireframe_tpu.ops.pallas_encoder import fused_point_encoder as jax_k1
from wireframe_tpu_torch.ops import chain_grad, fused_encoder

BOUND = dict(rtol=1e-5, atol=1e-5)
GRAD_BOUND = dict(rtol=1e-4, atol=1e-4)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (`cvt.rna.tf32.f32`): add half of the 13 dropped bits to the
    sign-magnitude pattern, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x.float() - hi)


def dot_3xtf32(h, w, compute_dtype):
    """The kernels' f32 product: the two small terms, then hi(A) hi(B)."""
    assert compute_dtype == torch.float32
    ah, al = split(h)
    bh, bl = split(w)
    return (al @ bh + ah @ bl) + ah @ bh


def dot_1xtf32(h, w, compute_dtype):
    """One TF32 pass: the operands as the tensor core reads raw f32."""
    assert compute_dtype == torch.float32
    return to_tf32(h) @ to_tf32(w)


def _allclose(got, want, bound):
    return all(np.allclose(g, w, **bound) for g, w in zip(got, want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_split_is_exact_to_two_to_the_minus_22(seed):
    """hi keeps 11 significant bits (its low 13 bits are 0), lo the
    next 11, and x - hi - lo is within 2^-22 |x| (in float64)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=4096)
                          * 10.0 ** rng.uniform(-6, 6, size=4096))
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64, rest = x.double(), (x.double() - hi.double() - lo.double()).abs()
    assert bool((x.double() - hi.double()).abs().le(
        2.0 ** -11 * x64.abs()).all())
    assert bool(rest.le(2.0 ** -22 * x64.abs()).all())
    assert float(rest.max()) > 0.0       # lo is rounded, not exact


def test_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11               # exactly half a TF32 ulp above 1
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12],
                     dtype=torch.float32)
    assert to_tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                   1.0, 1.0 + 2.0 ** -10]


@pytest.mark.parametrize("seed", [0, 1])
def test_three_products_are_f32_accurate(seed):
    """At a dot of 2048 terms, 3xTF32 sits within a few f32 ulps of the
    float64 product, as the plain f32 product does; one pass is ~1e3
    times further off."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(64, 2048)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2048, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err = lambda t: float((t.double() - exact).abs().max()) / scale  # noqa
    three, one, f32 = (dot_3xtf32(a, b, torch.float32),
                       dot_1xtf32(a, b, torch.float32), a @ b)
    assert err(three) < 4 * max(err(f32), 2.0 ** -24)
    assert err(one) > 100 * err(three)


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("backward", ["stash", "remat"])
def test_emulated_chain_matches_jax_f32(monkeypatch, flavour, backward):
    """K2 + K3 (stash) and K5 (remat) with the kernels' 3xTF32 products:
    outputs within rtol = atol = 1e-5 and every gradient within rtol =
    atol = 1e-4 of the JAX chain in f32 (Pallas in interpret mode)."""
    kv_pool, emit = FLAVOURS[flavour]
    sp, fw, fb = _params(1)
    x = _cloud(2)
    want_o, want_g = _run_jax(x, sp, fw, fb, kv_pool, emit, "float32",
                              backward)
    monkeypatch.setattr(chain_grad, "dot", dot_3xtf32)
    got_o, got_g = _run_torch(x, sp, fw, fb, kv_pool, emit, "float32",
                              backward)
    assert len(got_o) == len(want_o) and len(got_g) == len(want_g)
    for g, w in zip(got_o, want_o):
        np.testing.assert_allclose(g, w, **BOUND)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}",
                                   **GRAD_BOUND)


@pytest.mark.parametrize("backward", ["stash", "remat"])
def test_one_tf32_pass_misses_the_f32_bound(monkeypatch, backward):
    """The same chain with a single TF32 product is outside both."""
    kv_pool, emit = FLAVOURS["kv"]
    sp, fw, fb = _params(1)
    x = _cloud(2)
    want_o, want_g = _run_jax(x, sp, fw, fb, kv_pool, emit, "float32",
                              backward)
    monkeypatch.setattr(chain_grad, "dot", dot_1xtf32)
    got_o, got_g = _run_torch(x, sp, fw, fb, kv_pool, emit, "float32",
                              backward)
    assert not _allclose(got_o, want_o, BOUND)
    assert not _allclose(got_g, want_g, GRAD_BOUND)


def _k1(monkeypatch, dot, kv_pool):
    rng = np.random.default_rng(7)
    d, dims, c = 8, (48, 80), 40
    prev, sp = d, []
    for h in dims:
        sp.append(((rng.normal(size=(prev, h)) * 0.3).astype(np.float32),
                   (rng.normal(size=h) * 0.1).astype(np.float32),
                   (1 + rng.normal(size=h) * 0.1).astype(np.float32),
                   (rng.normal(size=h) * 0.1).astype(np.float32)))
        prev = h
    fw = (rng.normal(size=(prev, c)) * 0.2).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, 64, d)).astype(np.float32)
    x[0, 50:] = 0.0
    want = jax_k1(jnp.asarray(x), tuple(tuple(map(jnp.asarray, s))
                                        for s in sp),
                  jnp.asarray(fw), jnp.asarray(fb), tile=32,
                  compute_dtype=jnp.float32, kv_pool=kv_pool,
                  interpret=True)
    monkeypatch.setattr(fused_encoder, "dot", dot)
    got = fused_encoder.fused_point_encoder(
        torch.from_numpy(x), [tuple(map(torch.from_numpy, s)) for s in sp],
        torch.from_numpy(fw), torch.from_numpy(fb), tile=32,
        compute_dtype=torch.float32, kv_pool=kv_pool)
    keys = sorted(k for k in got if k in want)
    assert keys
    return ([got[k].numpy() for k in keys],
            [np.asarray(want[k]) for k in keys])


@pytest.mark.parametrize("kv_pool", [0, 4])
def test_emulated_k1_matches_the_pallas_encoder_f32(monkeypatch, kv_pool):
    got, want = _k1(monkeypatch, dot_3xtf32, kv_pool)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BOUND)


def test_one_tf32_pass_k1_misses_the_f32_bound(monkeypatch):
    got, want = _k1(monkeypatch, dot_1xtf32, 4)
    assert not _allclose(got, want, BOUND)
