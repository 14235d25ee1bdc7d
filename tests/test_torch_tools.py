"""The port's measuring tools on the CPU, at tiny size.

- `tools.bench_latency` writes its grid (and its probe) as markdown where
  `--out` says and never touches the repository's `BENCH_LATENCY.md`, a
  TPU record;
- `tools.trace_ops` sorts the kernel names `chip_smoke.py` profiles into
  the port's kernel groups and the library ones, parses a Chrome trace's
  device events (kernels, copies, memsets; never host events) per step,
  splits them by the program span open at each one's launch, and refuses
  `--trace-dir` without `--steps`;
- `tools.profile_train_step` and `tools.compile_report` run end to end
  with `--device cpu` (on the CPU the kernels' plain versions run and no
  library is built);
- `ops._build` builds into the directory a caller names and times each
  of its parallel compiles on its own (a stand-in compiler on the CPU).
"""

import glob
import json
import os

import pytest

from wireframe_tpu_torch.ops import _build
from wireframe_tpu_torch.tools import (
    bench_latency,
    compile_report,
    profile_train_step,
    trace_ops,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "recommended.yaml")
SMALL = ["model.encoder_hidden_dims=32,64", "model.encoder_output_dim=32",
         "model.decoder_dim=32", "model.decoder_layers=2",
         "model.decoder_heads=4", "model.decoder_ffn_dim=64",
         "data.max_vertices=8", "model.edge_hidden_dim=32",
         "model.edge_num_heads=4", "model.pallas_tile=64",
         "model.pallas_chain_tile=64"]


def _sets(overrides):
    return [a for o in overrides for a in ("--set", o)]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_latency_writes_out_and_leaves_bench_latency_md(tmp_path,
                                                               capsys):
    record = os.path.join(ROOT, "BENCH_LATENCY.md")
    with open(record, "rb") as f:
        before = f.read()
    out = tmp_path / "lat" / "latency.md"
    argv = ["--config", RECIPE, *_sets(SMALL), "--dtype", "float32",
            "--batches", "1,2", "--buckets", "64,128", "--iters", "3",
            "--device", "cpu", "--out", str(out)]
    assert bench_latency.main(argv) == 0
    grid = _last_json(capsys)
    assert grid["metric"] == "serving_latency_grid"
    assert set(grid["grid"]) == {"64x1", "64x2", "128x1", "128x2"}
    for cell in grid["grid"].values():
        assert 0 < cell["p50_ms"] <= cell["p99_ms"]
    text = out.read_text()
    assert "| 128 | 2 |" in text and "Measured on `cpu`" in text
    assert bench_latency.main(argv[:-4] + [
        "--device", "cpu", "--out", str(out), "--probe", "64,2",
        "--probe-iters", "4"]) == 0
    probe = _last_json(capsys)
    assert probe["iters"] == 4 and probe["dispatch_p50_ms"] > 0
    assert "Outlier probe" in out.read_text()
    with open(record, "rb") as f:
        assert f.read() == before


# Kernel names chip_smoke.py profiles (K1_KERNELS, K1_PARTS and
# TRAIN_KERNELS there) as torch.profiler spelled them on the H100, and
# library names.
NAMES = {
    "void hgemm::(anonymous namespace)::wgmma_chain_kernel<0, 3, 0>"
    "(hgemm::(anonymous namespace)::Params)":
        "K1 (fused encoder)",
    "k1_finalize_kernel(float const*, float*, float*, float*, int, int, "
    "int, int)": "K1 (fused encoder)",
    "void hgemm::(anonymous namespace)::wgmma_chain_kernel<0, 1, 0>"
    "(hgemm::(anonymous namespace)::Params)":
        "K2/K3/K5 (encoder chain)",
    "void hgemm::(anonymous namespace)::wgmma_chain_kernel<1, 2, 1>"
    "(hgemm::(anonymous namespace)::Params)":
        "K2/K3/K5 (encoder chain)",
    "void hgemm::(anonymous namespace)::wgmma_chain_kernel<2, 0, 0>"
    "(hgemm::(anonymous namespace)::Params)":
        "K2/K3/K5 (encoder chain)",
    "hgemm::(anonymous namespace)::prep_x_kernel(float const*, int, "
    "__nv_bfloat16*, int, unsigned char*, int)": "K2/K3/K5 (encoder chain)",
    "window_pool_kernel(float const*, unsigned char const*, float*, int*, "
    "float*, int, int, int)": "K2/K3/K5 (encoder chain)",
    "seed_kernel(float const*, int const*, float*)":
        "K2/K3/K5 (encoder chain)",
    "(anonymous namespace)::colsum_kernel(float const*, float*, int, "
    "long long)":
        "K2/K3/K5 (encoder chain)",
    "void (anonymous namespace)::lsa_kernel<64>(float const*, int const*, "
    "int*, int*, int, int, int)": "K4 (lockstep JV)",
    "void (anonymous namespace)::pair_mlp_kernel<512>((anonymous "
    "namespace)::Params)": "pair MLP (edge head)",
    "(anonymous namespace)::nbr_table_kernel((anonymous namespace)::"
    "Params)": "PTv3 maps and convs",
    "void (anonymous namespace)::nbr_query_kernel<5>((anonymous "
    "namespace)::Params)": "PTv3 maps and convs",
    "void (anonymous namespace)::subm_conv_kernel<64, 128, 64, 64, 4>("
    "(anonymous namespace)::Params)": "PTv3 maps and convs",
    "void (anonymous namespace)::knn_kernel<16>(float const*, long long "
    "const*, long long const*, long long*, int, int)": "PTv2 kNN",
    "void (anonymous namespace)::gva_kernel<192, 16>((anonymous namespace)::"
    "Params)": "PTv2 GVA",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopB_NNT":
        "library GEMM (cuBLAS / CUTLASS)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
        "library GEMM (cuBLAS / CUTLASS)",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>":
        "library GEMM (cuBLAS / CUTLASS)",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, "
    "float, float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue>":
        "attention / softmax",
    "Memcpy HtoD (Pageable -> Device)": "copy / cast",
    "Memset (Device)": "copy / cast",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>":
        "copy / cast",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >":
        "elementwise / reduce",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
    "4> >": "elementwise / reduce",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<float, float>": "elementwise / reduce",
    "some_unknown_kernel": "other",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_trace_ops_groups_kernel_names(name):
    assert trace_ops.classify(name) == NAMES[name]


def _chrome_trace(path, steps):
    """A small trace: device kernels, a copy and a memset per step, and
    host events (an operator, a runtime call) that must not count."""
    events = []
    for s in range(steps):
        t = 1000.0 * s
        events += [
            {"ph": "X", "cat": "kernel", "ts": t, "dur": 100.5,
             "name": "void hgemm::(anonymous namespace)::wgmma_chain_kernel"
                     "<0, 1, false>(CUtensorMap_st)"},
            {"ph": "X", "cat": "kernel", "ts": t + 200, "dur": 20.0,
             "name": "void (anonymous namespace)::lsa_kernel<64>()"},
            {"ph": "X", "cat": "kernel", "ts": t + 300, "dur": 50.0,
             "name": "nvjet_tst_64x8_64x16_4x1_v_bz_TNT"},
            {"ph": "X", "cat": "gpu_memcpy", "ts": t + 400, "dur": 4.0,
             "name": "Memcpy DtoH (Device -> Pinned)"},
            {"ph": "X", "cat": "gpu_memset", "ts": t + 410, "dur": 1.0,
             "name": "Memset (Device)"},
            {"ph": "X", "cat": "cpu_op", "ts": t, "dur": 900.0,
             "name": "aten::mm"},
            {"ph": "X", "cat": "cuda_runtime", "ts": t, "dur": 5.0,
             "name": "cudaLaunchKernel"},
            {"ph": "i", "cat": "kernel", "ts": t, "name": "instant"},
        ]
    path.mkdir()
    (path / "1.2.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))


def test_trace_ops_parses_a_chrome_trace(tmp_path, capsys):
    _chrome_trace(tmp_path / "trace", steps=2)
    out = tmp_path / "ops.json"
    assert trace_ops.main(["--trace-dir", str(tmp_path / "trace"),
                           "--steps", "2", "--json", str(out)]) == 0
    result = _last_json(capsys)
    assert result == json.loads(out.read_text())
    assert result["events"] == 10
    assert result["total_ms"] == pytest.approx(0.1755)
    assert result["profiler_device_ms"] is None
    assert result["groups_ms"] == pytest.approx({
        "K2/K3/K5 (encoder chain)": 0.1005, "K4 (lockstep JV)": 0.02,
        "library GEMM (cuBLAS / CUTLASS)": 0.05, "copy / cast": 0.005})
    assert sum(result["groups_ms"].values()) == pytest.approx(
        result["total_ms"])
    # No event carries a correlation id or an External id here.
    assert result["spans_ms"] == {trace_ops.NOT_FOUND: pytest.approx(
        {"inclusive": 0.1755, "self": 0.1755})}


def _span_trace(path):
    """One step with the program's spans, in microseconds.  Main thread
    (tid 1): forward 0-100 holding encoder 10-50, loss 100-150 holding
    matcher 110-130, backward 150-300 in which the main thread waits.
    The autograd thread (tid 2) launches the backward's kernel at 200.
    Launches: a runtime call (encoder), a driver call (forward's own), an
    External id naming a host op (matcher), the backward's runtime call
    on tid 2, a copy after every span, and a kernel whose launch the
    trace lacks.  The device-side range of the host op (a
    gpu_user_annotation, listed first) shares its External id and is not
    a launch."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid, "args": args}

    events = [
        x("user_annotation", "wf.forward", 0, 100),
        x("user_annotation", "wf.encoder", 10, 40),
        x("user_annotation", "wf.loss", 100, 50),
        x("user_annotation", "wf.matcher", 110, 20),
        x("user_annotation", "wf.backward", 150, 150),
        x("user_annotation", "pb.step", 0, 400),
        x("cuda_runtime", "cudaLaunchKernelExC", 20, 2, correlation=1),
        x("cuda_driver", "cuLaunchKernel", 60, 2, correlation=2),
        x("gpu_user_annotation", "wf.matcher", 440, 5, tid=7,
          **{"External id": 77}),
        x("cpu_op", "aten::add", 115, 3, **{"External id": 77}),
        x("cuda_runtime", "cudaLaunchKernel", 200, 2, tid=2,
          correlation=5),
        x("cuda_runtime", "cudaMemcpyAsync", 350, 2, correlation=6),
        x("kernel", "void hgemm::wgmma_chain_kernel<0, 1, 1, 0>()", 400,
          30, tid=7, correlation=1),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
          430, 10, tid=7, correlation=2),
        x("kernel", "void lsa_kernel<64>()", 440, 5, tid=7, correlation=3,
          **{"External id": 77}),
        x("kernel", "void seed_kernel<float>()", 450, 40, tid=7,
          correlation=5),
        x("kernel", "void orphan_kernel()", 490, 2, tid=7, correlation=4,
          **{"External id": 99}),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 500, 3, tid=7,
          correlation=6),
    ]
    path.mkdir()
    (path / "1.3.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))


def test_trace_ops_splits_device_time_by_span(tmp_path, capsys):
    _span_trace(tmp_path / "trace")
    assert trace_ops.main(["--trace-dir", str(tmp_path / "trace"),
                           "--steps", "1"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out.strip().splitlines()[-1])
    assert "device time by program span" in out
    ms = {k: (v["inclusive"] * 1e3, v["self"] * 1e3)
          for k, v in result["spans_ms"].items()}
    assert ms == {"forward": pytest.approx((40.0, 10.0)),
                  "encoder": pytest.approx((30.0, 30.0)),
                  "loss": pytest.approx((5.0, 0.0)),
                  "matcher": pytest.approx((5.0, 5.0)),
                  "backward": pytest.approx((40.0, 40.0)),
                  trace_ops.NO_SPAN: pytest.approx((3.0, 3.0)),
                  trace_ops.NOT_FOUND: pytest.approx((2.0, 2.0))}
    # Self times add up to the device total; by group within each span.
    assert sum(v for _, v in ms.values()) == pytest.approx(
        result["total_ms"] * 1e3)
    assert result["span_groups_ms"]["encoder"] == pytest.approx(
        {"K2/K3/K5 (encoder chain)": 0.03})
    assert result["span_groups_ms"]["matcher"] == pytest.approx(
        {"K4 (lockstep JV)": 0.005})
    assert result["span_groups_ms"][trace_ops.NO_SPAN] == pytest.approx(
        {"copy / cast": 0.003})


def test_trace_ops_trace_dir_needs_steps(tmp_path, capsys):
    _chrome_trace(tmp_path / "trace", steps=1)
    with pytest.raises(SystemExit) as exc:
        trace_ops.main(["--trace-dir", str(tmp_path / "trace")])
    assert exc.value.code == 2
    assert "--steps" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        trace_ops.main(["--trace-dir", str(tmp_path), "--steps", "1"])


def test_trace_ops_captures_on_the_cpu(capsys, monkeypatch):
    """The captured trace is parsed from a temporary directory that is
    gone when the tool returns."""
    seen = {}
    parse = trace_ops.aggregate_device_events

    def spy(trace_dir):
        seen["dir"] = trace_dir
        seen["traces"] = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        return parse(trace_dir)

    monkeypatch.setattr(trace_ops, "aggregate_device_events", spy)
    assert trace_ops.main(["--config", RECIPE, *_sets(SMALL),
                           "--set", "model.compute_dtype=float32",
                           "--batch", "2", "--points", "128", "--steps", "2",
                           "--device", "cpu"]) == 0
    result = _last_json(capsys)
    # The CPU trace holds host events only.
    assert result["profiler_device_ms"] == 0 and result["events"] == 0
    assert result["spans_ms"] == {}
    assert len(seen["traces"]) == 1
    assert not os.path.exists(seen["dir"])


def test_profile_train_step_on_the_cpu(capsys):
    assert profile_train_step.main([
        "--config", RECIPE, *_sets(SMALL),
        "--set", "model.compute_dtype=float32", "--batch", "2",
        "--points", "128", "--iters", "2", "--device", "cpu"]) == 0
    result = _last_json(capsys)
    assert set(result["ms"]) == {"full_step", "forward_only",
                                 "encoder_fwd_bwd", "lsa_matching"}
    assert result["share_of_step"]["full_step"] == 1.0
    assert all(v > 0 for v in result["ms"].values())
    assert result["chain_backward"] == "stash"
    assert result["clouds_per_sec"] == pytest.approx(
        2 / result["ms"]["full_step"] * 1e3)


def test_compile_report_on_the_cpu(tmp_path, capsys):
    yaml = tmp_path / "narrow.yaml"
    yaml.write_text("data: {max_vertices: 8, point_buckets: [64, 128]}\n"
                    "model: {encoder_hidden_dims: [32, 64], "
                    "encoder_output_dim: 32, edge_hidden_dim: 32, "
                    "edge_num_heads: 4}\n")
    assert compile_report.main(["--config", str(yaml), "--batch", "2",
                                "--points", "64", "--device", "cpu",
                                "--programs", "train,lsa,fwd_bucket"]) == 0
    report = _last_json(capsys)
    assert report["builds"] == {} and report["build_dir"] is None
    assert set(report["programs"]) == {"train_step_B2", "lsa_B2",
                                       "forward_B8_64", "forward_B8_128"}
    for row in report["programs"].values():
        assert row["first_exec_s"] > 0 and row["second_exec_s"] > 0


def test_build_into_a_named_directory(tmp_path):
    default = _build.library_path("lockstep_lsa")
    named = _build.library_path("lockstep_lsa", tmp_path)
    assert default.parent == _build.BUILD_DIR
    assert named == tmp_path / default.name


def test_parallel_builds_time_each_nvcc_on_its_own(tmp_path, monkeypatch):
    """build_all starts one compiler per source together; each build's
    seconds end with its own process (a stand-in compiler here: the
    first source is slow, the others fast), into the named directory."""
    import stat
    import sys

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(3.0 if sys.argv[-1].endswith('fused_encoder.cu') "
        "else 0.1)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info: 0 bytes spill stores')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    names = ["fused_encoder", "chain_grad", "lockstep_lsa"]
    built = _build.build_all(names, tmp_path / "cold")
    secs = {n: built[n][1] for n in names}
    assert secs["fused_encoder"] >= 3.0
    assert secs["chain_grad"] < 2.5 and secs["lockstep_lsa"] < 2.5
    for n in names:
        path, _, log = built[n]
        assert path.parent == tmp_path / "cold" and path.exists()
        assert "ptxas" in log
    # Built once: a second call finds every library and builds nothing.
    assert all(s == 0.0 for _, s, _ in
               _build.build_all(names, tmp_path / "cold").values())
