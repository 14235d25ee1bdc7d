"""Share of the card's bf16 dense peak that the window's inference rate
reaches with the PTv3 configuration: the forward's operations a cloud
over the pool's clouds (`counts_ptv3`, from the clouds' own grid
coordinates) x clouds/s, in %.  None where the cell's Driver counted nothing."""

from port_bench import counts


def read(r):
    w = r.window
    if r.device_name == "cpu" or "flops_per_cloud" not in w:
        return None
    rate = w["clouds"] / w["wall"]
    return 100.0 * w["flops_per_cloud"] * rate / counts.compute_peak(
        r.device_name, r.dtype)
