"""Padding rows of PTv3's patch attention over its real rows in the
window, in %, from the backbone's device counters (read after the
window).  None where the program has no such counters."""


def read(r):
    c = r.window.get("ptv3_counters")
    if not c or c["attn_real_rows"] <= 0:
        return None
    return 100.0 * c["attn_padded_rows"] / c["attn_real_rows"]
