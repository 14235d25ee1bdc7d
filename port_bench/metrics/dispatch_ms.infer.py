"""Host milliseconds an inference call takes to send: its copy in, the
forward's dispatch and its copies back, on the benchmark's clock, without
the waits for results: the mean over the window's calls (profiler off).
Below the card's time a call, the card sets the pace."""

from port_bench.drivers.infer import SEND_SPANS


def read(r):
    w = r.window
    if "t0" not in w or not w.get("calls"):
        return None
    sent = sum(sum(r.spans.durations(n, w["t0"], w["t1"]))
               for n in SEND_SPANS)
    return 1e3 * sent / w["calls"]
