"""K4's device milliseconds a train step (the lockstep assignment solver,
`csrc/lockstep_lsa.cu`), from the profiled segment."""

KERNELS = ("lsa_kernel", "lsa_block_kernel")


def read(r):
    seg = r.segment
    if seg is None or r.device_name == "cpu":
        return None
    seconds = seg.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / r.window["segment_units"]
