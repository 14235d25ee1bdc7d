"""The yardstick's operation counts and peaks."""

import json
import os

import pytest

from port_bench import counts, harness

ROOT = os.path.dirname(harness.PACKAGE_DIR)


def model(name):
    with open(os.path.join(ROOT, "port_bench", "configs",
                           name + ".json")) as f:
        return json.load(f)["model"]


def test_point_mlp_forward_is_10_49_mflop():
    # 2 * (8*512 + 512*1024 + 1024*2048 + 2048*1024 + 1024*512)
    assert counts.point_mlp_flops(model("recipe")) == 10_493_952


def test_recipe_forward_per_cloud():
    """28.4 GFLOP a recipe cloud at 2560 points in PERF.md's history
    (bench.py's count); this count adds the layers bench.py leaves out
    (cross-attention output projections, attention scores of the slots,
    the pair layer's slot products): 28.52 GFLOP."""
    f = counts.forward_flops_per_cloud(model("recipe"), 2560)
    assert abs(f - 28.4e9) < 0.2e9
    assert f == pytest.approx(28_519_103_488)


def test_training_and_backward_factors():
    m = model("parity")
    fwd = counts.point_mlp_flops(m) * 100
    assert counts.chain_flops(m, 100) == fwd
    assert counts.chain_flops(m, 100, "stash") == 3 * fwd
    assert counts.chain_flops(m, 100, "remat") == 4 * fwd
    assert counts.train_flops_per_cloud(m, 2560) == \
        3 * counts.forward_flops_per_cloud(m, 2560)


def test_peaks_by_card_and_dtype():
    name = "NVIDIA H100 80GB HBM3"
    assert counts.compute_peak(name, "bfloat16") == 989.4e12
    assert counts.compute_peak(name, "float32") == 494.7e12
    assert counts.peaks(name)["hbm"] == 3.35e12
    with pytest.raises(KeyError):
        counts.peaks("NVIDIA A100-SXM4-80GB")


def test_least_time_takes_the_larger_bound():
    name = "NVIDIA H100 80GB HBM3"
    assert counts.least_seconds(989.4e12, 0, name, "bfloat16") == 1.0
    assert counts.least_seconds(0, 3.35e12, name, "bfloat16") == 1.0
