"""Percentiles, interval unions and the reduction of a profiled segment."""

import json

import pytest

from port_bench import stats, trace


def test_nearest_rank_p95():
    values = list(range(1, 101))                  # 1 .. 100
    # rank round(0.95 * 99) = 94 -> the 95th smallest value
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(20)), 95) == 18
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (2.5, 4.0)]
    assert stats.union(iv) == [(0.0, 4.0), (5.0, 6.0)]
    assert stats.covered(iv, 0.0, 10.0) == 5.0
    assert stats.covered(iv, 3.0, 5.5) == 1.5
    assert stats.gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (4.0, 5.0),
                                         (6.0, 7.0)]


def _chrome(tmp_path):
    us = 1e6

    def ev(cat, name, a, b):
        return {"ph": "X", "cat": cat, "name": name, "ts": a * us,
                "dur": (b - a) * us}

    events = [
        ev("user_annotation", "pb.segment", 10.0, 20.0),
        ev("gpu_user_annotation", "pb.segment", 10.5, 19.0),
        ev("user_annotation", "pb.step", 10.0, 15.0),
        ev("user_annotation", "pb.h2d", 15.0, 16.0),
        ev("kernel", "void lsa_kernel(float const*)", 11.0, 12.0),
        ev("kernel", "void wgmma_chain_kernel<0, 1, 0, 0>(Params)", 11.5,
           13.0),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 15.2, 15.8),
        ev("kernel", "void some_new_kernel_kernel()", 17.0, 18.0),
        ev("cpu_op", "aten::mm", 10.0, 11.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_segment_busy_is_the_union(tmp_path):
    seg = trace.parse_chrome(_chrome(tmp_path))
    outer = [s for s in seg.spans if s[0] == "segment"]
    assert len(outer) == 1            # the GPU-side annotation is not a span
    seg.start, seg.end = outer[0][1], outer[0][2]
    seg.spans = [s for s in seg.spans if s[0] != "segment"]
    # kernels 11-13 overlap: 2 s, the copy 0.6 s, the last kernel 1 s
    assert seg.busy() == pytest.approx(3.6)
    assert seg.seconds_of(("lsa_kernel",)) == pytest.approx(1.0)
    assert seg.seconds_of(("lsa_block_kernel",)) == 0.0
    # idle 10-11 and 13-15.2 inside "step", 15.8-17 and 18-20 in no span
    assert seg.idle_gaps() == [["step", pytest.approx(2.2)],
                               ["no span", pytest.approx(2.0)],
                               ["no span", pytest.approx(1.2)],
                               ["step", pytest.approx(1.0)]]


def test_breakdown_names_unclaimed_port_kernels(tmp_path):
    seg = trace.parse_chrome(_chrome(tmp_path))
    seg.start, seg.end = 10.0, 20.0
    ops = dict((k, v) for k, v in trace.breakdown(seg, ("lsa_kernel",))
               ["device_ops"])
    assert any(k.startswith("unclaimed port kernel: void wgmma_chain")
               for k in ops)
    assert not any("lsa_kernel" in k and k.startswith("unclaimed")
                   for k in ops)
    assert ops["K4 (lockstep JV)"] == pytest.approx(1.0)
