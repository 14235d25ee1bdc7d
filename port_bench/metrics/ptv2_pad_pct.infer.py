"""Neighbour slots PTv2's grouped vector attention computes beyond the
real ones (capacity rows past the real rows, and the slots of clouds
with fewer than k rows), over the real slots in the window, in %, from
the backbone's device counters (read after the window).  None where the
program has no such counters."""


def read(r):
    c = r.window.get("ptv2_counters")
    if not c or c["gva_real_slots"] <= 0:
        return None
    return 100.0 * (c["gva_slots"] - c["gva_real_slots"]) \
        / c["gva_real_slots"]
