"""`idle_pct.infer` in the PTv2 cell: the share of the profiled
segment's wall time in which nothing ran on the card, in %."""

import os

from port_bench.harness import PACKAGE_DIR, metric_module

read = metric_module(os.path.dirname(PACKAGE_DIR), "idle_pct.infer").read
