"""PTv3's submanifold conv kernel's share of its roofline in an inference
call: the least time of a call's convolutions (the stem and every xCPE
conv) over the summed device time of `subm_conv_kernel` a call in the
profiled segment, in %.  The kernel: `csrc/subm_conv.cu`.

The least time is the larger of
- operations: 2 pairs CIN COUT a conv, over the (row, offset) pairs that
  exist (the window's `conv_pairs.stem` and `conv_pairs.stageS` a call,
  each level's count for each of its convs), at the dtype's dense peak;
- bytes at HBM bandwidth, all on the levels' capacity rows: each conv's
  input rows read once, its map at 4 bytes a slot, its weights and bias,
  its outputs written once, bf16.
None where the kernel never ran (a program without it, or a path that
does not take it)."""

from port_bench import counts

KERNELS = ("subm_conv_kernel",)


def convolutions(m):
    """(level, CIN, COUT, offsets, bias) of each conv of a forward: the
    stem (k = 5, no bias) on level 0, then each stage's xCPE convs (k = 3)
    on its level, encoder and decoder."""
    enc_c, dec_c = m["ptv3_enc_channels"], m["ptv3_dec_channels"]
    enc_d, dec_d = m["ptv3_enc_depths"], m["ptv3_dec_depths"]
    out = [("stem", m["input_dim"], enc_c[0], 125, False)]
    for s, c in enumerate(enc_c):
        out += [(s, c, c, 27, True)] * enc_d[s]
        if s < len(dec_c):
            out += [(s, dec_c[s], dec_c[s], 27, True)] * dec_d[s]
    return out


def read(r):
    seg, w = r.segment, r.window
    c, rows = w.get("ptv3_counters"), w.get("ptv3_capacity_rows")
    if seg is None or r.device_name == "cpu" or not c or not c.get(
            "calls") or not rows:
        return None
    seconds = seg.seconds_of(KERNELS) / w["segment_units"]
    if seconds <= 0:
        return None
    flops = nbytes = 0.0
    for level, cin, cout, k, bias in convolutions(r.model):
        m = rows[0 if level == "stem" else level]
        key = "stem" if level == "stem" else f"stage{level}"
        pairs = c[f"conv_pairs.{key}"] / c["calls"]
        flops += 2.0 * pairs * cin * cout
        nbytes += (2 * m * (cin + cout) + 4 * m * k + 2 * k * cin * cout
                   + (2 * cout if bias else 0))
    least = counts.least_seconds(flops, nbytes, r.device_name, r.dtype)
    return 100.0 * least / seconds
