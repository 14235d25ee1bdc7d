"""`dispatch_ms.infer` in the PTv2 cell: host milliseconds an inference
call takes to send (copy in, the forward's dispatch, copies back),
without the waits for results."""

import os

from port_bench.harness import PACKAGE_DIR, metric_module

read = metric_module(os.path.dirname(PACKAGE_DIR), "dispatch_ms.infer").read
