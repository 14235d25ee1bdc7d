"""PTv2's GVA kernel's share of its roofline in an inference call: the
least time of a call's grouped vector attentions (one a block: the patch
embed's, the encoder's and the decoder's) over the summed device time of
`gva_kernel` a call in the profiled segment, in %.  The kernel:
`csrc/gva.cu`.

The least time is the larger of
- operations: 2 slots (3C + C^2 + CG + G^2 + C) a GVA (`counts_ptv2.
  block_flops`' slot terms: pe1, pe2, we1, we2, the weighted sum), over
  the real neighbour slots (the window's `knn_slots.levelL` a call, each
  level's count at its largest k, times k / that k for a block at a
  smaller k), at the dtype's dense peak;
- bytes at HBM bandwidth, all on the levels' capacity rows (the window's
  `ptv2_capacity_rows`): q, k and v read once in the compute dtype, xyz at
  12 bytes a row, the indices at 8 bytes a slot, the weights and the
  other parameters once (f32), the output written once (f32).
None where the kernel never ran (a program without it, or a path that
does not take it)."""

from port_bench import counts

KERNELS = ("gva_kernel",)


def attentions(m):
    """(level, C, G, k) of each GVA of a forward: the patch embed's on
    level 0, encoder stage s's on level s + 1, decoder stage s's on level
    s."""
    out = [(0, m["ptv2_patch_embed_channels"], m["ptv2_patch_embed_groups"],
            m["ptv2_patch_embed_neighbours"])] * m["ptv2_patch_embed_depth"]
    for s, depth in enumerate(m["ptv2_enc_depths"]):
        out += [(s + 1, m["ptv2_enc_channels"][s], m["ptv2_enc_groups"][s],
                 m["ptv2_enc_neighbours"][s])] * depth
    for s, depth in enumerate(m["ptv2_dec_depths"]):
        out += [(s, m["ptv2_dec_channels"][s], m["ptv2_dec_groups"][s],
                 m["ptv2_dec_neighbours"][s])] * depth
    return out


def read(r):
    seg, w = r.segment, r.window
    c, rows = w.get("ptv2_counters"), w.get("ptv2_capacity_rows")
    ks = w.get("ptv2_level_k")
    if (seg is None or r.device_name == "cpu" or not c or not c.get("calls")
            or not rows or not ks):
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    item = 2 if r.dtype == "bfloat16" else 4
    flops = nbytes = 0.0
    for level, ch, g, k in attentions(r.model):
        slots = c[f"knn_slots.level{level}"] / c["calls"] * k / ks[level]
        flops += 2.0 * slots * (3 * ch + ch * ch + ch * g + g * g + ch)
        nbytes += (rows[level] * (3 * item * ch + 12 + 8 * k + 4 * ch)
                   + 4 * (ch * ch + g * ch + g * g + 20 * ch + 6 * g))
    least = counts.least_seconds(flops, nbytes, r.device_name, r.dtype)
    return 100.0 * least / seconds
