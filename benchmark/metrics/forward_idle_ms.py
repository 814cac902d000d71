"""forward_idle_ms (the reader of forward_idle_ms.train): the device's idle ms a
step of the traced sub-window while a `gan.*.forward` span was the innermost
program span open (`_spans.idle_by_phase`)."""

from benchmark.metrics._spans import phase_idle_ms


def read(ctx):
    return phase_idle_ms(ctx, "forward")
