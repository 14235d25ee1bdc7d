"""Host milliseconds a train step spends inside the step call, on the
benchmark's clock: the mean over the window's steps (profiler off)."""


def read(r):
    w = r.window
    calls = r.spans.durations("step", w["t0"], w["t1"])
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
