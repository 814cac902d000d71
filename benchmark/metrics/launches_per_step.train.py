"""launches_per_step.train: the kernels the profiler saw launched in the
traced sub-window (those inside a replayed CUDA graph among them), over
its steps."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["launches"]:
        return None
    return trace["launches"] / ctx["steps"]
