"""Host time of the training plan's draws a step: the self time of the
profiler's host ``aten::normal_`` events over the steps traced."""


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    draws = [e for e in ctx.events if e.kind == "cpu" and e.name == "aten::normal_"]
    if not steps or not draws:
        return None
    return sum(e.self_us for e in draws) / 1e3 / steps
