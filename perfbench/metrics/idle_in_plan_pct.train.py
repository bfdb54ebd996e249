"""Share of the traced window in which the device was idle while the host
made the training plan (its draws and its copy): the exact overlap of the
device's idle gaps with the program's ``fit.plan`` spans, over the
window's length."""
from perfbench.metrics._span_idle import overlap_pct


def read(ctx):
    return overlap_pct(ctx, "fit.plan")
