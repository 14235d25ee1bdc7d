"""On the card, at each cell's own size: the control (the reference put
in the program's place in the precision below the configuration's: fp8
operands for bf16, TF32 for float32) fails at least one of the cell's
limits on three seeds, and a sound run of the program passes them all.

    python -m pytest port_bench/tests/test_pb_card.py -m card
"""

import json
import os

import pytest

from port_bench import harness

ROOT = os.path.dirname(harness.PACKAGE_DIR)
SEEDS = (9007199254740993, 4294967311, 2305843009213693951)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = [w["name"] for w in json.load(_f)["workloads"]]


def _over(numbers, limits):
    """The numbers the cell compares that exceed their limits."""
    return sorted(k for k, lim in limits.items() if numbers[k] > lim)


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(card, workload):
    cell = harness.load_cell(ROOT, workload)
    for seed in SEEDS:
        driver = harness.driver_class(cell)(cell, seed, card,
                                            harness.Spans())
        driver.setup()
        driver.window(2.0)
        driver.free()
        assert not _over(driver.program_numbers(), cell.limits), seed
        assert _over(driver.control_numbers(), cell.limits), seed
