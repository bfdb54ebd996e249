"""The client release's ``privacy_conv`` kernel against its roofline: the
least time of every call (``work.conv_work`` at the call's shape) over the
device time of the kernels named ``privacy_conv`` in the trace."""
from perfbench import trace, work


def read(ctx):
    calls = ctx.counts.get("privacy_conv_calls", 0)
    spent = trace.device_time_us(ctx.events, "privacy_conv") / 1e6
    if not calls or spent <= 0:
        return None
    least = calls * work.conv_work(*ctx.counts["privacy_conv_shape"],
                                   ctx.cfg["privacy_noise"])["bound_s"]
    return 100.0 * least / spent
