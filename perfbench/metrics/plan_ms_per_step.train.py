"""Host time of the training plan a step: the summed duration of the
program's ``fit.plan`` spans (the epoch's indices and noise drawn, then
copied to the device) that start in the traced window, over the steps
traced."""


def read(ctx):
    win = [e for e in ctx.events if e.kind == "cpu" and e.name == "perfbench.window"]
    steps = ctx.counts.get("steps", 0)
    if not win or not steps:
        return None
    lo, hi = win[0].start_us, win[0].end_us
    plans = [e for e in ctx.events
             if e.kind == "cpu" and e.name == "fit.plan" and lo <= e.start_us < hi]
    if not plans:
        return None
    return sum(e.dur_us for e in plans) / 1e3 / steps
