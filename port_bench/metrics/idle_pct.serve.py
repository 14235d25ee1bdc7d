"""Share of the profiled segment's wall time in which no kernel, copy or
memset ran on the card (the union of the device events' intervals, not
their sum), in %."""


def read(r):
    seg = r.segment
    if seg is None or r.device_name == "cpu" or seg.wall <= 0:
        return None
    return 100.0 * (1.0 - seg.busy() / seg.wall)
