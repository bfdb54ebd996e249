"""Host time the serve loop waits for the trunk a dispatched batch: the
summed duration of the program's ``serve.readback`` spans (the outputs'
copy to the host, which waits for the trunk's device work, and their
routing) over the count of its ``serve.trunk`` spans, both starting in the
traced window."""


def read(ctx):
    win = [e for e in ctx.events if e.kind == "cpu" and e.name == "perfbench.window"]
    if not win:
        return None
    lo, hi = win[0].start_us, win[0].end_us
    cpu = [e for e in ctx.events if e.kind == "cpu" and lo <= e.start_us < hi]
    trunks = sum(e.name == "serve.trunk" for e in cpu)
    if not trunks:
        return None
    return sum(e.dur_us for e in cpu if e.name == "serve.readback") / 1e3 / trunks
