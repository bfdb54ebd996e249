"""The LM training step's share of the card's bf16 peak: the model
operations of every step traced (``work_lm.lm_train_flops``: matrix
products and attention, forward and backward, recompute not counted), over
the traced window's time, over 989 TFLOP/s."""
from perfbench import work_lm


def read(ctx):
    flops = ctx.counts.get("model_flops", 0)
    if not flops or ctx.window_s <= 0:
        return None
    return 100.0 * flops / ctx.window_s / work_lm.PEAK_BF16_FLOPS_PER_S
