"""PTv2's kNN kernel's share of its roofline in an inference call: the
least time of a call's kNN searches (one a level, at the level's largest
k) over the summed device time of `knn_kernel` a call in the profiled
segment, in %.  The kernel: `csrc/knn.cu`.

The least time is bytes at HBM bandwidth, on the levels' capacity rows
(the window's `ptv2_capacity_rows`): each level's coordinates, cloud id
and validity read once (12 + 8 + 1 bytes a row), and each index written
once at its stored width (8 bytes, rows x k).  None where the kernel
never ran (a program without it, or a path that does not take it)."""

from port_bench import counts

KERNELS = ("knn_kernel",)
# xyz 3 x float32, cloud id int64, valid bool; indices int64.
ROW_BYTES, INDEX_BYTES = 3 * 4 + 8 + 1, 8


def read(r):
    seg, w = r.segment, r.window
    rows, ks = w.get("ptv2_capacity_rows"), w.get("ptv2_level_k")
    if seg is None or r.device_name == "cpu" or not rows or not ks:
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    nbytes = sum(m * (ROW_BYTES + INDEX_BYTES * k) for m, k in zip(rows, ks))
    least = counts.least_seconds(0.0, nbytes, r.device_name, r.dtype)
    return 100.0 * least / seconds
