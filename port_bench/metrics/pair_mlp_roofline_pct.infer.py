"""The edge head's pair MLP kernel's share of its roofline in an inference
batch: the least time of the pair MLP at the cell's shapes (operations at
the dtype's dense peak, or bytes at HBM bandwidth, the larger) over the
summed device time of `pair_mlp_kernel` a batch in the profiled segment,
in %.  The kernel: `csrc/pair_mlp.cu`.  None where the kernel never ran
(a program without it, or a path that does not take it)."""

from port_bench import counts

KERNELS = ("pair_mlp_kernel",)


def read(r):
    seg, w = r.segment, r.window
    if seg is None or r.device_name == "cpu":
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    m = r.model
    b, v, f = w["batch"], m["max_vertices"], m["edge_hidden_dim"]
    rows = b * v * (v - 1) // 2
    size = 2 if r.dtype == "bfloat16" else 4
    weights = f * f // 2 + f // 2 * f // 4
    flops = 2.0 * rows * (weights + f // 4)
    # u_i, u_j and the slots' coordinates in; W3, W4 and the f32 vector of
    # biases, LayerNorm terms, w_d and w5; logits and probabilities out.
    nbytes = (size * (2 * b * v * f + 3 * b * v + weights)
              + 4 * (4 * f + 3 * f // 2 + 2 * f // 4 + 1) + 8 * rows)
    least = counts.least_seconds(flops, nbytes, r.device_name, r.dtype)
    return 100.0 * least / seconds
