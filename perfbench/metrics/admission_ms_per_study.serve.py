"""Host time of a study's admission while serving: the summed duration of
the program's ``serve.admit`` spans (rows, noise, release and push of one
offered study) that start in the traced window, over their count."""


def read(ctx):
    win = [e for e in ctx.events if e.kind == "cpu" and e.name == "perfbench.window"]
    if not win:
        return None
    lo, hi = win[0].start_us, win[0].end_us
    admits = [e for e in ctx.events
              if e.kind == "cpu" and e.name == "serve.admit" and lo <= e.start_us < hi]
    if not admits:
        return None
    return sum(e.dur_us for e in admits) / 1e3 / len(admits)
