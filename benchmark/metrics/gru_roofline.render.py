"""gru_roofline.render: as gru_roofline.train, of the forward kernel
calls of the traced synthesis calls."""

from benchmark.metrics._gru import roofline


def read(ctx):
    return roofline(ctx, ("gru_fwd",))
