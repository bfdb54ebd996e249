"""The selective scan's kernels against their roofline in LM training: the
least bytes of every launch in the window (``work_lm``: each hospital's
forward in the client, without checkpoints; the trunk's forwards, with
them; the trunk's backwards) at 3.35 TB/s, over the device time of the
kernels named ``selective_scan_kernel`` and ``selective_scan_bwd_kernel``."""
from perfbench import work, work_lm
from perfbench.metrics._scan_time import scan_seconds


def read(ctx):
    c = ctx.counts
    fwd, bwd = c.get("scan_forward_launches", 0), c.get("scan_backward_launches", 0)
    spent = sum(scan_seconds(ctx))
    if not fwd or spent <= 0:
        return None
    ub, client = c["scan_u_bytes"], c["scan_client_launches"]
    least = (client * work_lm.scan_forward_bytes(*c["scan_client_shape"], ub, False)
             + (fwd - client) * work_lm.scan_forward_bytes(*c["scan_trunk_shape"], ub, True)
             + bwd * work_lm.scan_backward_bytes(*c["scan_trunk_shape"], ub))
    return 100.0 * least / work.PEAK_BYTES_PER_S / spent
