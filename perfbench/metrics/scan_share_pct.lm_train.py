"""The selective scan's kernels' share of the device's busy time in the
traced window (forward and backward, ``_scan_time``)."""
from perfbench.metrics._scan_time import scan_seconds


def read(ctx):
    spent = sum(scan_seconds(ctx))
    if spent <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * spent / ctx.busy_s
