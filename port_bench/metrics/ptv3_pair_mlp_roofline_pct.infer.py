"""`pair_mlp_roofline_pct.infer` in the PTv3 cell: the edge head's pair
MLP kernel behind the PTv3 backbone, at the cell's batch, over its
roofline, in %.  None where the kernel never ran."""

import os

from port_bench.harness import PACKAGE_DIR, metric_module

read = metric_module(os.path.dirname(PACKAGE_DIR),
                     "pair_mlp_roofline_pct.infer").read
