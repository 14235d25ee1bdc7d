"""`python -m port_bench ...`: see `port_bench.run`."""

import time

T0 = time.perf_counter()    # set-up is timed from here

import sys  # noqa: E402

from port_bench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
