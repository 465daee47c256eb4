"""``latent_fwd_ms_per_step``: device time of the whitened latent model's
forward, the four profiler ranges of ``build_latent_whitened``'s log density
(``gaplac.latent.gram``, ``.factor``, ``.map``, ``.loglik``), per batched
leapfrog.  With CUDA activity traced, the profiler gives each range a device
event from its first kernel's start to its last kernel's end; the card's
torch gives that event no activity type, so ``trace.summarize`` keeps it
among the device's operations, named as the range.  A program without the
ranges gives nothing to read."""

PATTERN = r"^gaplac\.latent\.(gram|factor|map|loglik)$"


def read(ctx):
    seconds, count = ctx.trace.kernel_seconds(PATTERN)
    if not count or not ctx.calls:
        return None
    return 1e3 * seconds / ctx.calls
