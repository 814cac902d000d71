"""idle_share (the reader of idle_share.train, idle_share.render and their
splits): 1 - the device's busy time (the union of its kernels' and
copies' spans) over the traced sub-window's wall time, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
