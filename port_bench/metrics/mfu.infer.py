"""Share of the card's dense peak for the configuration's dtype that the
window's inference rate reaches: the forward matmul operations a cloud x
clouds/s, in %."""

from port_bench import counts


def read(r):
    w = r.window
    if r.device_name == "cpu":
        return None
    rate = w["clouds"] / w["wall"]
    flops = counts.forward_flops_per_cloud(r.model, w["points"])
    return 100.0 * flops * rate / counts.compute_peak(r.device_name,
                                                      r.dtype)
