"""comm_ms_per_step.train: the device time of the NCCL kernels on rank 0
a step of the traced sub-window; None where no collective ran."""

from benchmark import yardstick as Y


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    spent = sum(s for name, s in trace["by_op"].items() if Y.kernel_family(name) == "nccl")
    if spent <= 0:
        return None
    return 1e3 * spent / ctx["steps"]
