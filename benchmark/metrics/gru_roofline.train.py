"""gru_roofline.train: the GRU forward, backward recurrence and dW kernel
calls of the traced train steps, their frozen least time (bytes or
operations at the data sheet's rates, from each call's shape) over their
device time."""

from benchmark.metrics._gru import roofline


def read(ctx):
    return roofline(ctx, ("gru_fwd", "gru_bwd", "gru_dw"))
