"""The guard's ``dp_release`` kernel against its roofline in training:
the least time of every release (``work.release_work`` at the release's
shape) over the device time of the kernels named ``dp_release``."""
from perfbench import trace, work


def read(ctx):
    calls = ctx.counts.get("dp_release_calls", 0)
    spent = trace.device_time_us(ctx.events, "dp_release") / 1e6
    if not calls or spent <= 0:
        return None
    least = calls * work.release_work(ctx.counts["dp_release_shape"],
                                      work.sigma(ctx.cfg["guard"]))["bound_s"]
    return 100.0 * least / spent
