"""``aten_ms_per_step``: device time of ATen's own kernels (elementwise,
reductions, indexing, copies between layouts, and the CUB kernels ATen
launches) per batched leapfrog."""

PATTERN = r"at::native|at_cuda_detail|at::cuda|cub::"


def read(ctx):
    seconds, count = ctx.trace.kernel_seconds(PATTERN)
    if not count or not ctx.calls:
        return None
    return 1e3 * seconds / ctx.calls
