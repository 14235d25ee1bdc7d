"""PTv3's neighbour map kernels' share of their roofline in an inference
call: the least time of a call's six maps (the stem's size-5 map on level
0, then a size-3 map on every level for its xCPE convs) over the summed
device time of the map kernels a call in the profiled segment, in %.  The
kernels: `csrc/neighbour_map.cu` (the hash table's build and the
lookups).

The least time is bytes at HBM bandwidth, on the levels' capacity rows
(the window's `ptv3_capacity_rows`): each level's key, grid, batch and
valid read once a level (41 bytes a row), and each map written once (8
bytes a slot, rows x offsets).  None where the kernels never ran (a
program without them, or a path that does not take them)."""

from port_bench import counts

KERNELS = ("nbr_table_kernel", "nbr_query_kernel")
# key int64, grid 3 x int64, batch int64, valid bool.
ROW_BYTES = 8 + 3 * 8 + 8 + 1


def maps(levels):
    """(level, offsets) of each map of a forward."""
    return [(0, 125)] + [(s, 27) for s in range(levels)]


def read(r):
    seg, w = r.segment, r.window
    rows = w.get("ptv3_capacity_rows")
    if seg is None or r.device_name == "cpu" or not rows:
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    nbytes = ROW_BYTES * sum(rows) + sum(
        8 * rows[level] * k for level, k in maps(len(rows)))
    least = counts.least_seconds(0.0, nbytes, r.device_name, r.dtype)
    return 100.0 * least / seconds
