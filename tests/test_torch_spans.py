"""The program's spans (`utils.profiling.span`) on the CPU, at tiny size.

- With no profiler running a span is the one shared null context and
  never reaches `torch.profiler.record_function`;
- under `torch.profiler.profile` one train step and one `make_forward_fn`
  call leave exactly the nine "wf." ranges in the Chrome trace, nested as
  the layers are: the encoder, the vertex head and the edge head inside
  the step's forward (and at the top of the inference forward), the
  matcher inside the loss, the step's stages one after another;
- a profiled step computes bit for bit what an unprofiled one does.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wireframe_tpu_torch.config import load_config
from wireframe_tpu_torch.train.loop import device_batch, init_model
from wireframe_tpu_torch.train.state import create_train_state
from wireframe_tpu_torch.train.step import make_forward_fn, make_train_step
from wireframe_tpu_torch.utils import profiling
from wireframe_tpu_torch.utils.synth import make_random_batch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_chain_tile=32",
         "data.num_points=64", "train.batch_size=2",
         "model.compute_dtype=float32", "model.use_pallas_encoder=true",
         "train.device_augment=true", "data.augment=true"]
# The recipe (query decoder, stash chain) and the reference architecture
# (MLP vertex head, remat chain, `matcher: device`).
CONFIG_FILES = {"recipe": "recommended.yaml", "parity": "default.yaml"}
STEP_SPANS = ("augment", "forward", "loss", "backward", "optimizer")
MODEL_SPANS = ("encoder", "vertex_head", "edge_head")


def _setup(name):
    cfg = load_config(os.path.join(CONFIGS, CONFIG_FILES[name]), SMALL)
    dev = torch.device("cpu")
    state = create_train_state(cfg, init_model(cfg, dev, seed=0))
    batch = device_batch(make_random_batch(cfg, 2), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    return cfg, state, batch, gen


def _ranges(prof, tmp_path):
    """[(name without "wf.", start us, end us, thread)] of the trace's
    program spans, by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(ev["name"][3:], float(ev["ts"]),
            float(ev["ts"]) + float(ev["dur"]), ev.get("tid"))
           for ev in events if ev.get("ph") == "X"
           and ev.get("cat") == "user_annotation"
           and ev["name"].startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("encoder"), profiling.span("loss")
    assert first is second is profiling._OFF
    with first:
        pass


def test_span_on_is_a_named_range(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("encoder")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(3).sum()
    assert [r[0] for r in _ranges(prof, tmp_path)] == ["encoder"]


@pytest.mark.parametrize("name", sorted(CONFIG_FILES))
def test_step_and_forward_spans_nest_as_the_layers(name, tmp_path):
    cfg, state, batch, gen = _setup(name)
    step, forward = make_train_step(cfg), make_forward_fn(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch, gen)
        forward(state.model, batch["point_clouds"])
    ranges = _ranges(prof, tmp_path)
    names = [r[0] for r in ranges]
    assert sorted(set(names)) == sorted(STEP_SPANS + MODEL_SPANS
                                        + ("matcher",))
    # One of each step stage; the model's three in the step and again in
    # the inference forward.
    assert sorted(names) == sorted(STEP_SPANS + ("matcher",)
                                   + 2 * MODEL_SPANS)
    by = {n: [r for r in ranges if r[0] == n] for n in set(names)}
    stages = [by[n][0] for n in STEP_SPANS]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    fwd, loss = by["forward"][0], by["loss"][0]
    assert _inside(by["matcher"][0], loss)
    in_step, in_call = {}, {}
    for n in MODEL_SPANS:
        first, second = by[n]
        assert _inside(first, fwd) and not _inside(second, fwd)
        assert second[1] > by["optimizer"][0][2]
        in_step[n], in_call[n] = first, second
    for group in (in_step, in_call):
        order = [group[n] for n in MODEL_SPANS]
        assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    # Every range of the step and of the call is on the caller's thread.
    assert len({r[3] for r in ranges}) == 1


def test_a_profiled_step_computes_the_same_bits(tmp_path):
    """Two steps from the same state, batch and generator state, one under
    the profiler: the metrics, every parameter, both Adam moments and the
    EMA agree bit for bit, and so does the forward after them."""
    out = []
    for profiled in (False, True):
        cfg, state, batch, gen = _setup("recipe")
        step, forward = make_train_step(cfg), make_forward_fn(cfg)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                state, metrics = step(state, batch, gen)
                preds = forward(state.model, batch["point_clouds"])
            assert len(_ranges(prof, tmp_path)) == 12
        else:
            state, metrics = step(state, batch, gen)
            preds = forward(state.model, batch["point_clouds"])
        out.append((metrics, dict(state.params), dict(state.mu),
                    dict(state.nu), dict(state.ema_params), preds))
    (m0, p0, mu0, nu0, e0, f0), (m1, p1, mu1, nu1, e1, f1) = out
    for a, b in ((m0, m1), (p0, p1), (mu0, mu1), (nu0, nu1), (e0, e1),
                 (f0, f1)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("flagged", [True, False])
def test_device_rows_leave_the_spans_device_copies_out(flagged):
    """On the card a span has a device-side copy (a gpu_user_annotation
    from its first kernel to its last) whose row is of device type CUDA;
    `device_rows` counts kernels, copies and memsets only, whether or not
    the row says it is a user annotation."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def row(key, us, device, annotation=False):
        r = SimpleNamespace(key=key, count=2, self_device_time_total=us,
                            device_type=device)
        if flagged:
            r.is_user_annotation = annotation
        return r

    rows = [row("void lsa_kernel<64>()", 30.0, DeviceType.CUDA),
            row("Memcpy HtoD (Pageable -> Device)", 5.0, DeviceType.CUDA),
            row(profiling.SPAN_PREFIX + "backward", 500.0, DeviceType.CUDA,
                annotation=True),
            row("aten::mm", 30.0, DeviceType.CPU)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert profiling.device_rows(prof) == [
        (0.03, 2, "void lsa_kernel<64>()"),
        (0.005, 2, "Memcpy HtoD (Pageable -> Device)")]


def test_device_rows_of_a_profile_with_spans_on_the_cpu(tmp_path):
    cfg, state, batch, gen = _setup("parity")
    step = make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, gen)
    assert len(_ranges(prof, tmp_path)) == 9       # one of each
    assert profiling.device_rows(prof) == []      # no card, no device rows
