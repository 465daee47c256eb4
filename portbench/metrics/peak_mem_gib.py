"""``peak_mem_gib``: the most device memory the allocator held for tensors
during the window (``torch.cuda.max_memory_allocated`` after a reset at the
window's start)."""


def read(ctx):
    if not ctx.window.peak_bytes:
        return None
    return ctx.window.peak_bytes / 2**30
