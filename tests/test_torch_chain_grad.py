"""K2 / K3 / K5 plain versions (the stash and remat chains) against JAX.

The three flavours of `make_differentiable_chain(backward=...)` (Pallas
in interpret mode) and the port's `differentiable_chain` (the plain
versions of K2 + K3, or K5, on the CPU) get the same numpy inputs: padded
rows, an all-padding sample, and duplicated rows that make exact ties in
the window max.  Outputs and every gradient (x and all parameters) are
compared with the JAX tests' own tolerances
(tests/test_pallas_chain_grad.py:279-384): f32 forward rtol = atol = 1e-5,
f32 gradients rtol 1e-3, atol 2e-4.  In bf16 both sides round the same
operands but sum in other orders, so a rounding can flip; the bf16 stash
uses the JAX bf16 test's rtol = atol = 5e-2.

The bf16 remat chain is held tighter, to rtol = atol = 1e-3 on every
gradient (1e-4 on the outputs): at these shapes the port's remat
gradients are within 1e-4 of JAX's, while the stash and remat gradients
differ by up to 0.48 (2e-2 relative; z round-trips through bf16 in the
stash).  The test also checks that the stash's gradients fail that
tolerance, so it tells the two backward flavours apart.

`window_max_pool`'s gradient, and the eager masked / unmasked pools the
features flavour feeds, are compared with `jax.grad` the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wireframe_tpu.ops.masked_pool import (
    masked_max as jax_masked_max,
    masked_mean as jax_masked_mean,
    window_max_pool as jax_window_max_pool,
)
from wireframe_tpu.ops.pallas_chain_grad import make_differentiable_chain
from wireframe_tpu_torch.ops import _build
from wireframe_tpu_torch.ops._launch import launch_counts
from wireframe_tpu_torch.ops.chain_grad import (
    chain_backward,
    chain_backward_plain,
    chain_forward,
    chain_forward_plain,
    differentiable_chain,
    remat_chain_backward,
    remat_chain_forward,
)
from wireframe_tpu_torch.ops.masked_pool import (
    masked_max,
    masked_mean,
    point_validity_mask,
    window_max_pool,
)

TOL = {"float32": dict(fwd=dict(rtol=1e-5, atol=1e-5),
                       grad=dict(rtol=1e-3, atol=2e-4)),
       "bfloat16": dict(fwd=dict(rtol=5e-2, atol=5e-2),
                        grad=dict(rtol=5e-2, atol=5e-2))}
REMAT_BF16 = dict(fwd=dict(rtol=1e-4, atol=1e-4),
                  grad=dict(rtol=1e-3, atol=1e-3))
FLAVOURS = {"features": (0, True), "kv": (4, True), "kv_slim": (4, False)}


def _params(seed, d=8, dims=(16, 32), c=24):
    rng = np.random.default_rng(seed)
    prev, sp = d, []
    for h in dims:
        sp.append(((rng.normal(size=(prev, h)) / np.sqrt(prev)),
                   rng.normal(size=h) * 0.1, 1.0 + rng.normal(size=h) * 0.1,
                   rng.normal(size=h) * 0.1))
        prev = h
    sp = [tuple(a.astype(np.float32) for a in s) for s in sp]
    fw = (rng.normal(size=(prev, c)) / np.sqrt(prev)).astype(np.float32)
    fb = (rng.normal(size=c) * 0.1).astype(np.float32)
    return sp, fw, fb


def _cloud(seed, b=3, n=64, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    x[0, 40:] = 0.0            # padding tail
    x[1, 8:12] = 0.0           # a fully invalid window mid-cloud
    x[1, 17] = x[1, 16]        # duplicated rows: exact ties in a window
    x[1, 22] = x[1, 21]
    x[2] = 0.0                 # an all-padding sample
    return x


def _loss_weights(shapes, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _run_jax(x, sp, fw, fb, kv_pool, emit, dtype, backward="stash"):
    chain = make_differentiable_chain(
        tile=32, compute_dtype=getattr(jnp, dtype), interpret=True,
        backward=backward, kv_pool=kv_pool, emit_features=emit)
    outs = chain(jnp.asarray(x), tuple(tuple(map(jnp.asarray, s))
                                       for s in sp),
                 jnp.asarray(fw), jnp.asarray(fb))
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [jnp.asarray(w) for w in _loss_weights([o.shape for o in outs])]

    def loss(x, sp, fw, fb):
        o = chain(x, sp, fw, fb)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * w) + 0.1 * jnp.sum(a ** 2)
                   for a, w in zip(o, ws))

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), tuple(tuple(map(jnp.asarray, s)) for s in sp),
        jnp.asarray(fw), jnp.asarray(fb))
    flat = [grads[0]] + [g for s in grads[1] for g in s] + [grads[2],
                                                           grads[3]]
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in flat]


def _run_torch(x, sp, fw, fb, kv_pool, emit, dtype, backward="stash"):
    xt = torch.tensor(x, requires_grad=True)
    spt = [tuple(torch.tensor(a, requires_grad=True) for a in s) for s in sp]
    fwt = torch.tensor(fw, requires_grad=True)
    fbt = torch.tensor(fb, requires_grad=True)
    outs = differentiable_chain(xt, spt, fwt, fbt, kv_pool=kv_pool,
                                emit_features=emit,
                                compute_dtype=getattr(torch, dtype),
                                backward=backward)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [torch.from_numpy(w)
          for w in _loss_weights([tuple(o.shape) for o in outs])]
    loss = sum(torch.sum(a * w) + 0.1 * torch.sum(a ** 2)
               for a, w in zip(outs, ws))
    leaves = [xt] + [t for s in spt for t in s] + [fwt, fbt]
    grads = torch.autograd.grad(loss, leaves)
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


def _chain_matches_jax(flavour, dtype, backward):
    kv_pool, emit = FLAVOURS[flavour]
    sp, fw, fb = _params(1)
    x = _cloud(2)
    want_o, want_g = _run_jax(x, sp, fw, fb, kv_pool, emit, dtype, backward)
    got_o, got_g = _run_torch(x, sp, fw, fb, kv_pool, emit, dtype, backward)
    tol = TOL[dtype]
    if backward == "remat" and dtype == "bfloat16":
        tol = REMAT_BF16
        # The stash flavour's gradients lie outside this tolerance.
        _, stash_g = _run_torch(x, sp, fw, fb, kv_pool, emit, dtype)
        assert not all(np.allclose(s, w, **tol["grad"])
                       for s, w in zip(stash_g, want_g))
    assert len(got_o) == len(want_o)
    for g, w in zip(got_o, want_o):
        np.testing.assert_allclose(g, w, **tol["fwd"])
    if kv_pool:
        # The all-padding sample and the invalid window pool to 0.
        assert np.abs(got_o[-2][2]).max() == 0.0
        assert np.abs(got_o[-2][1, 2]).max() == 0.0
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}",
                                   **tol["grad"])


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stash_chain_matches_jax(flavour, dtype):
    _chain_matches_jax(flavour, dtype, "stash")


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_chain_matches_jax(flavour, dtype):
    _chain_matches_jax(flavour, dtype, "remat")


@pytest.mark.parametrize("remat", [False, True])
def test_plain_backward_is_the_forward_s_gradient(remat):
    """K3's plain version (from the stash) and K5's (recomputing, remat),
    written out by hand, against autograd through K2's arithmetic in f32
    (where the stash is exact), kv_pool with features: the hand-written
    backward is the true gradient."""
    sp, fw, fb = _params(3)
    x = torch.from_numpy(_cloud(4)[:2])
    leaves = [x.clone().requires_grad_()] + [
        torch.tensor(a, requires_grad=True) for s in sp for a in s] + [
        torch.tensor(fw, requires_grad=True),
        torch.tensor(fb, requires_grad=True)]
    stages = [tuple(leaves[1 + 4 * i: 5 + 4 * i]) for i in range(len(sp))]

    def forward_autograd(x, stages, fw, fb):
        h = x
        for w, b, g, be in stages:
            z = h @ w + b
            mu = z.mean(-1, keepdim=True)
            var = ((z - mu) ** 2).mean(-1, keepdim=True)
            h = torch.maximum((z - mu) * torch.rsqrt(var + 1e-6) * g + be,
                              torch.zeros(()))
        return h @ fw + fb

    out = forward_autograd(leaves[0], stages, leaves[-2], leaves[-1])
    res = chain_forward_plain(x, stages, leaves[-2], leaves[-1], kv_pool=4,
                              compute_dtype=torch.float32)
    np.testing.assert_allclose(res["features"].detach().numpy(),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    dpool = torch.from_numpy(rng.normal(
        size=res["pooled"].shape).astype(np.float32))
    dsums = torch.from_numpy(rng.normal(
        size=res["sums"].shape).astype(np.float32))
    valid = point_validity_mask(x)
    b, n, c = out.shape
    # The kv scatter's reference: the cotangent of the window max goes to
    # the saved argmax row (no exact ties among distinct valid rows here).
    onehot = torch.nn.functional.one_hot(
        res["idx"].long(), 4).permute(0, 1, 3, 2).reshape(b, n, c)
    win_valid = valid.reshape(b, n // 4, 4).any(-1)
    surrogate = (torch.sum(out * g)
                 + torch.sum(out * onehot * torch.repeat_interleave(
                     torch.where(win_valid[..., None], dpool,
                                 torch.zeros(())), 4, dim=1))
                 + torch.sum(torch.where(valid[..., None], out,
                                         torch.zeros(()))
                             * torch.repeat_interleave(dsums, 4, dim=1)))
    want = torch.autograd.grad(surrogate, leaves)
    dx, dst, dfw, dfb = chain_backward_plain(
        x, stages, leaves[-2], leaves[-1], None if remat else res["zs"],
        g=g, kv_pool=4,
        dpool=dpool, idx=res["idx"], dsums=dsums,
        compute_dtype=torch.float32)
    got = [dx] + [t for s in dst for t in s] + [dfw, dfb]
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), w.numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=f"gradient {i}")


def no_kernel_library(monkeypatch):
    """Make loading any kernel library fail the test: the CPU path must
    load none."""
    def load(name, *args, **kwargs):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", load)


def test_wrappers_take_plain_on_cpu_and_remat_raises(monkeypatch):
    """On CPU tensors the K2 / K3 / K5 wrappers take the plain versions,
    load no kernel library and count no launch; remat (formerly refused)
    saves no stash, and its forward equals the stash forward's (the stash
    is all it adds)."""
    sp, fw, fb = _params(6)
    x = torch.from_numpy(_cloud(7))
    stages = [tuple(torch.from_numpy(a) for a in s) for s in sp]
    fwt, fbt = torch.from_numpy(fw), torch.from_numpy(fb)
    no_kernel_library(monkeypatch)
    counts = launch_counts()
    res = chain_forward(x, stages, fwt, fbt, kv_pool=4, emit_features=False)
    assert set(res) == {"zs", "pooled", "idx", "sums"}
    assert [z.dtype for z in res["zs"]] == [torch.bfloat16] * 2
    cot = dict(kv_pool=4, dpool=torch.ones_like(res["pooled"]),
               idx=res["idx"], dsums=torch.zeros_like(res["sums"]))
    stash = chain_backward(x, stages, fwt, fbt, res["zs"], **cot)
    rem = remat_chain_forward(x, stages, fwt, fbt, kv_pool=4,
                              emit_features=False)
    assert set(rem) == {"pooled", "idx", "sums"}
    for k in rem:
        assert torch.equal(rem[k], res[k]), k
    remat = remat_chain_backward(x, stages, fwt, fbt, **cot)
    assert remat[0].shape == stash[0].shape
    assert launch_counts() == counts
    xg = x.clone().requires_grad_()
    out = differentiable_chain(xg, stages, fwt, fbt, backward="remat")
    saved = {id(t) for t in (xg, *[p for s in stages for p in s], fwt, fbt)}
    fn = out.grad_fn
    assert all(id(t) in saved for t in fn.saved_tensors)
    with pytest.raises(ValueError, match="unknown chain backward"):
        differentiable_chain(x, stages, fwt, fbt, backward="other")


@pytest.mark.parametrize("n", [64, 62])
def test_window_max_pool_gradient_matches_jax(n):
    """The whole cotangent goes to the lowest-index tied row and nothing
    to a fully-invalid window; N not a multiple of the window pads."""
    rng = np.random.default_rng(10)
    f = rng.normal(size=(2, n, 6)).astype(np.float32)
    f[0, 5] = f[0, 4]                      # exact tie inside a window
    f[1, 9] = f[1, 8] = f[1, 10]
    mask = rng.random((2, n)) > 0.2
    mask[1, 12:16] = False                 # a fully invalid window
    w = rng.normal(size=(2, -(-n // 4), 6)).astype(np.float32)

    def jloss(f):
        pooled, _ = jax_window_max_pool(f, jnp.asarray(mask), 4)
        return jnp.sum(pooled * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(f)))
    ft = torch.tensor(f, requires_grad=True)
    pooled, win = window_max_pool(ft, torch.from_numpy(mask), 4)
    (got,) = torch.autograd.grad(torch.sum(pooled * torch.from_numpy(w)), ft)
    np.testing.assert_array_equal(got.numpy(), want)
    _, jwin = jax_window_max_pool(jnp.asarray(f), jnp.asarray(mask), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))


def test_eager_pool_gradients_match_jax():
    """The features flavour's pools stay eager (models/encoder.py): the
    masked max / mean and unmasked mean / max of the features must give
    `jax.grad`'s cotangents, exactly: a max tied between rows splits its
    cotangent evenly (jnp.max's rule; torch.amax does the same), invalid
    rows get nothing, and an all-invalid cloud pools to 0 with a zero
    gradient."""
    rng = np.random.default_rng(12)
    f = rng.normal(size=(3, 10, 5)).astype(np.float32)
    f[0, 3] = f[0, 7]                      # exact ties among valid rows
    f[0, 1, 2] = f[0, 3, 2] = f[0, 7, 2] = 9.0
    f[1, 2] = f[1, 4]                      # a tie with an invalid row
    mask = rng.random((3, 10)) > 0.3
    mask[0, [1, 3, 7]] = True
    mask[1, 2], mask[1, 4] = True, False
    mask[2] = False                        # an all-invalid cloud
    ws = rng.normal(size=(4, 3, 5)).astype(np.float32)

    def jloss(f):
        m = jnp.asarray(mask)
        pools = (jax_masked_max(f, m), jax_masked_mean(f, m),
                 jnp.mean(f, axis=-2), jnp.max(f, axis=-2))
        return sum(jnp.sum(p * w) for p, w in zip(pools, ws)), pools

    (_, jpools), want = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(f))
    ft = torch.tensor(f, requires_grad=True)
    m = torch.from_numpy(mask)
    pools = (masked_max(ft, m), masked_mean(ft, m), torch.mean(ft, dim=-2),
             torch.amax(ft, dim=-2))
    loss = sum(torch.sum(p * torch.from_numpy(w)) for p, w in zip(pools, ws))
    (got,) = torch.autograd.grad(loss, ft)
    for p, jp in zip(pools, jpools):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
    assert np.all(pools[0].detach().numpy()[2] == 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert got[0, 3, 2] != 0.0 and got[0, 3, 2] == got[0, 7, 2]
