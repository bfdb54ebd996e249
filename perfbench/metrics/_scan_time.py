"""Device seconds of the selective scan's kernels in the traced window:
the forward's (named ``selective_scan_kernel``) and the backward's
(``selective_scan_bwd_kernel``)."""
from perfbench import trace

FORWARD, BACKWARD = "selective_scan_kernel", "selective_scan_bwd_kernel"


def scan_seconds(ctx):
    """``(forward, backward)`` device seconds."""
    return (trace.device_time_us(ctx.events, FORWARD) / 1e6,
            trace.device_time_us(ctx.events, BACKWARD) / 1e6)
