"""host_step_ms (the reader of host_step_ms.train and .train.graph): the
host's ms a step in the traced sub-window's outermost step-level program
spans, `program.run` where the steps run as programs, else
`gan.train_step`, less the graph's launch (`program.replay`), where the
host waits for the device and the profiler, over its steps
(`_spans.traced`)."""

from benchmark.metrics._spans import traced


def read(ctx):
    got = traced(ctx)
    if got is None or not got["host_ns"]:
        return None
    return got["host_ns"] / 1e6 / ctx["steps"]
