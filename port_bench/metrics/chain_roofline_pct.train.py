"""The encoder chain's share of its roofline in a train step: the least
time of the point MLP's forward and backward at the cell's shapes
(operations at the dtype's dense peak, or bytes at HBM bandwidth, the
larger) over the summed device time of the chain's kernels a step in the
profiled segment, in %.  The kernels: `csrc/chain_grad.cu` with
`hopper_gemm.cuh` (K2, K3, K5) and `csrc/layernorm_rows.cu`."""

from port_bench import counts

KERNELS = ("wgmma_chain_kernel", "prep_x_kernel", "window_pool_kernel",
           "seed_kernel", "colsum_kernel", "ln_fwd_rows_kernel",
           "ln_bwd_rows_kernel")


def read(r):
    seg, w = r.segment, r.window
    if seg is None or r.device_name == "cpu":
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    rows = w["batch"] * w["points"]
    backward = w["chain_backward"]
    least = counts.least_seconds(
        counts.chain_flops(r.model, rows, backward),
        counts.chain_bytes(r.model, w["batch"], w["points"], backward),
        r.device_name, r.dtype)
    return 100.0 * least / seconds
