"""The whole training step's share of the card's float32 peak: the
operations of every trained row (client forward; trunk forward, weight
and input gradients), over the traced window's time, over 67 TFLOP/s."""
from perfbench import work


def read(ctx):
    flops = ctx.counts.get("model_flops", 0)
    if not flops or ctx.window_s <= 0:
        return None
    return 100.0 * flops / ctx.window_s / work.PEAK_F32_FLOPS_PER_S
