"""The guard's ``dp_release`` kernel against its roofline in LM training:
the least bytes of every release (``work_lm.release_bytes``: the cut in
its type, float32 noise) at 3.35 TB/s, over the device time of the kernels
named ``dp_release``; None where a release is smaller than the L2, from
which it may read."""
from perfbench import trace, work, work_lm


def read(ctx):
    c = ctx.counts
    calls = c.get("dp_release_calls", 0)
    spent = trace.device_time_us(ctx.events, "dp_release") / 1e6
    if not calls or spent <= 0:
        return None
    nbytes = work_lm.release_bytes(c["dp_release_shape"], c["dp_release_x_bytes"],
                                   c["dp_release_noise_bytes"])
    if nbytes < work_lm.L2_BYTES:
        return None
    return 100.0 * calls * nbytes / work.PEAK_BYTES_PER_S / spent
