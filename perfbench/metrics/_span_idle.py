"""The share of the traced window in which the device was idle while the
host was inside one of the program's spans: the exact overlap of the
device's idle gaps (``trace.idle_gaps``) with the spans of one name,
merged and clipped to the window, over the window's length."""
from perfbench import trace


def overlap_pct(ctx, span_name):
    """None without the window or without a span of that name in it."""
    win = [e for e in ctx.events if e.kind == "cpu" and e.name == "perfbench.window"]
    if not win:
        return None
    lo, hi = win[0].start_us, win[0].end_us
    spans = [(e.start_us, e.end_us) for e in ctx.events
             if e.kind == "cpu" and e.name == span_name]
    inside = trace.merged(trace.clipped(spans, lo, hi))
    if not inside or hi <= lo:
        return None
    gaps, i, j, both = trace.idle_gaps(ctx.events, lo, hi), 0, 0, 0.0
    while i < len(gaps) and j < len(inside):
        both += max(0.0, min(gaps[i][1], inside[j][1]) - max(gaps[i][0], inside[j][0]))
        if gaps[i][1] < inside[j][1]:
            i += 1
        else:
            j += 1
    return 100.0 * both / (hi - lo)
