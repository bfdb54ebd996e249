"""Share of the traced window in which the device was idle while the host
was admitting a study (its rows, noise, release and push): the exact
overlap of the device's idle gaps with the program's ``serve.admit``
spans, over the window's length."""
from perfbench.metrics._span_idle import overlap_pct


def read(ctx):
    return overlap_pct(ctx, "serve.admit")
