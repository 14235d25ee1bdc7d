"""Share of the card's bf16 dense peak that the window's inference rate
reaches with the PTv2 configuration: the forward's operations a cloud
over the pool's clouds (`counts_ptv2`, from the clouds' own levels: the
positional bias and weight encoding on the real neighbour slots, the
heads as `counts.py`) x clouds/s, in %.  None where the cell's Driver
counted nothing."""

from port_bench import counts


def read(r):
    w = r.window
    if r.device_name == "cpu" or "ptv2_flops_per_cloud" not in w:
        return None
    rate = w["clouds"] / w["wall"]
    return 100.0 * w["ptv2_flops_per_cloud"] * rate / counts.compute_peak(
        r.device_name, r.dtype)
