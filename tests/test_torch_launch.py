"""The kernel-call layer (`ops._launch`) under the port's ten kernel
wrappers.

Every wrapper routes through `on_card`: a CPU tensor gets the plain
version, bit for bit, with no kernel library loaded and no launch counted;
a tensor on any other device but CUDA (`meta` here) raises ValueError.
The launch count itself: `count` keys f32 twins, `launch_counts` reads
all or some keys, `reset_launches` clears.
"""

import pytest
import torch

from wireframe_tpu_torch.ops._launch import (
    count,
    launch_counts,
    on_card,
    reset_launches,
)
from wireframe_tpu_torch.ops.chain_grad import (
    chain_backward,
    chain_backward_plain,
    chain_forward,
    chain_forward_plain,
    remat_chain_backward,
    remat_chain_forward,
)
from wireframe_tpu_torch.ops.fused_encoder import (
    fused_point_encoder,
    fused_point_encoder_plain,
)
from wireframe_tpu_torch.ops.layernorm_rows import (
    layernorm_relu_backward,
    layernorm_relu_backward_plain,
    layernorm_relu_forward,
    layernorm_relu_forward_plain,
)
from wireframe_tpu_torch.ops.lockstep_lsa import (
    solve_lsa_rows,
    solve_lsa_rows_lockstep_plain,
)
from wireframe_tpu_torch.ops.pair_mlp import (
    PairMlpParams,
    pair_mlp,
    pair_mlp_plain,
)
from wireframe_tpu_torch.ops.subm_conv import subm_conv, subm_conv_plain

BF16 = torch.bfloat16


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


def _chain(dev):
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, 2, 64, 8)
    sp, prev = [], 8
    for h in (16, 32):
        sp.append((_randn(gen, prev, h) / prev ** 0.5, 0.1 * _randn(gen, h),
                   1 + 0.1 * _randn(gen, h), 0.1 * _randn(gen, h)))
        prev = h
    fw, fb = _randn(gen, prev, 24) / prev ** 0.5, torch.zeros(24)
    zs = chain_forward_plain(x, sp, fw, fb)["zs"]
    g = _randn(gen, 2, 64, 24)
    to = lambda t: t.to(dev)  # noqa: E731
    return (to(x), [tuple(map(to, s)) for s in sp], to(fw), to(fb),
            tuple(map(to, zs)), to(g))


def _k2(dev):
    x, sp, fw, fb, _, _ = _chain(dev)
    kw = dict(kv_pool=4)
    return (lambda: chain_forward(x, sp, fw, fb, **kw),
            lambda: chain_forward_plain(x, sp, fw, fb, **kw))


def _k3(dev):
    x, sp, fw, fb, zs, g = _chain(dev)
    return (lambda: chain_backward(x, sp, fw, fb, zs, g=g),
            lambda: chain_backward_plain(x, sp, fw, fb, zs, g=g))


def _k5_fwd(dev):
    x, sp, fw, fb, _, _ = _chain(dev)
    return (lambda: remat_chain_forward(x, sp, fw, fb),
            lambda: chain_forward_plain(x, sp, fw, fb, stash=False))


def _k5_bwd(dev):
    x, sp, fw, fb, _, g = _chain(dev)
    return (lambda: remat_chain_backward(x, sp, fw, fb, g=g),
            lambda: chain_backward_plain(x, sp, fw, fb, None, g=g))


def _k1(dev):
    x, sp, fw, fb, _, _ = _chain(dev)
    kw = dict(tile=32, kv_pool=4, return_point_features=True)
    return (lambda: fused_point_encoder(x, sp, fw, fb, **kw),
            lambda: fused_point_encoder_plain(x, sp, fw, fb, **kw))


def _k4(dev):
    gen = torch.Generator().manual_seed(1)
    cost = torch.rand((3, 5, 7), generator=gen).to(dev)
    nr = torch.tensor([5, 3, 0], dtype=torch.int32).to(dev)
    return (lambda: solve_lsa_rows(cost, nr),
            lambda: solve_lsa_rows_lockstep_plain(cost, nr))


def _ln_rows(dev):
    gen = torch.Generator().manual_seed(2)
    z, dh = _randn(gen, 5, 40).to(dev), _randn(gen, 5, 40).to(dev)
    g, be = (1 + 0.1 * _randn(gen, 40)).to(dev), _randn(gen, 40).to(dev)
    return z, dh, g, be


def _ln_fwd(dev):
    z, _, g, be = _ln_rows(dev)
    kw = dict(h_dtype=BF16, stash_dtype=BF16)
    return (lambda: layernorm_relu_forward(z, g, be, **kw),
            lambda: layernorm_relu_forward_plain(z, g, be, **kw))


def _ln_bwd(dev):
    z, dh, g, be = _ln_rows(dev)
    kw = dict(dz_dtype=torch.float32, rebuild_h=True)
    return (lambda: layernorm_relu_backward(z, dh, g, be, **kw),
            lambda: layernorm_relu_backward_plain(z, dh, g, be, **kw))


def _pair(dev):
    gen = torch.Generator().manual_seed(3)
    b, v, f = 2, 6, 64
    shapes = [(f,), (f,), (f,), (f,), (f // 2, f), (f // 2,), (f // 2,),
              (f // 2,), (f // 4, f // 2), (f // 4,), (1, f // 4), (1,)]
    p = PairMlpParams(*(0.3 * _randn(gen, *s) for s in shapes))
    p = PairMlpParams(*(t.to(dev) for t in p))
    u_i, u_j = (_randn(gen, b, v, f).to(BF16).to(dev) for _ in range(2))
    x = _randn(gen, b, v, 3).to(BF16).to(dev)
    live = (torch.rand((b, v), generator=gen) > 0.3).to(dev)
    return (lambda: pair_mlp(u_i, u_j, x, live, p, dtype=BF16),
            lambda: pair_mlp_plain(u_i, u_j, x, live, p, dtype=BF16))


def _subm(dev):
    gen = torch.Generator().manual_seed(4)
    m, k, cin, cout = 50, 27, 8, 32
    x = _randn(gen, m, cin).to(dev)
    nbr = torch.randint(0, m + 1, (m, k), generator=gen).to(dev)
    w, b = _randn(gen, cout, k * cin).to(dev), _randn(gen, cout).to(dev)
    return (lambda: subm_conv(x, nbr, w, b, dtype=BF16),
            lambda: subm_conv_plain(x, nbr, w, b, dtype=BF16))


WRAPPERS = {"chain_forward": _k2, "chain_backward": _k3,
            "remat_chain_forward": _k5_fwd,
            "remat_chain_backward": _k5_bwd,
            "fused_point_encoder": _k1, "solve_lsa_rows": _k4,
            "layernorm_relu_forward": _ln_fwd,
            "layernorm_relu_backward": _ln_bwd, "pair_mlp": _pair,
            "subm_conv": _subm}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_routes_through_on_card(name, monkeypatch):
    from test_torch_chain_grad import no_kernel_library

    no_kernel_library(monkeypatch)
    call, plain = WRAPPERS[name]("cpu")
    before = launch_counts()
    got, want = _tensors(call()), _tensors(plain())
    assert launch_counts() == before
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta_call, _ = WRAPPERS[name]("meta")
    with pytest.raises(ValueError, match="runs on CUDA or CPU tensors"):
        meta_call()
    assert launch_counts() == before


def test_on_card_and_the_launch_count():
    assert on_card(torch.zeros(1), "K1") is False
    with pytest.raises(ValueError, match="K1 runs on CUDA or CPU tensors, "
                                         "not meta"):
        on_card(torch.zeros(1, device="meta"), "K1")
    reset_launches()
    count("K1")
    count("K1", torch.float32)
    count("K1", torch.bfloat16)
    count("K4 warp")
    assert launch_counts() == {"K1": 2, "K1 f32": 1, "K4 warp": 1}
    assert launch_counts(("K1", "K2")) == {"K1": 2, "K2": 0}
    reset_launches()
    assert launch_counts() == {}
