"""Share of the serve loop's trunk slots that carried a study: the
reports' ``batched_items`` over ``batches * max_batch`` (program counts)."""


def read(ctx):
    c = ctx.counts
    if not c.get("batches"):
        return None
    return 100.0 * c["batched_items"] / (c["batches"] * c["max_batch"])
