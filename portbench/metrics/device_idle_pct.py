"""``device_idle_pct``: share of the traced window in which no operation ran
on the device.  The run refuses a trace whose device time exceeds the
window (``run.py``), so this is never below 0."""


def read(ctx):
    busy = ctx.trace.busy_s
    if busy <= 0 or ctx.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.window.seconds)
