"""K1's share of its roofline in an inference batch: the least time of
the point MLP's forward with its pools at the cell's shapes (operations
at the dtype's dense peak, or bytes at HBM bandwidth, the larger) over
the summed device time of K1's kernels a batch in the profiled segment,
in %.  The kernels: `csrc/fused_encoder.cu` with `hopper_gemm.cuh` and
`csrc/layernorm_rows.cu`."""

from port_bench import counts

KERNELS = ("wgmma_chain_kernel", "prep_x_kernel", "k1_finalize_kernel",
           "ln_fwd_rows_kernel")


def read(r):
    seg, w = r.segment, r.window
    if seg is None or r.device_name == "cpu":
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    rows = w["batch"] * w["points"]
    least = counts.least_seconds(
        counts.chain_flops(r.model, rows),
        counts.chain_bytes(r.model, w["batch"], w["points"]),
        r.device_name, r.dtype)
    return 100.0 * least / seconds
