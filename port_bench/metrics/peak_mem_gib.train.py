"""The allocator's peak device memory over the window
(`torch.cuda.max_memory_allocated` after a reset at its start), GiB."""


def read(r):
    peak = r.window.get("peak_bytes", 0)
    if r.device_name == "cpu" or not peak:
        return None
    return peak / 2 ** 30
