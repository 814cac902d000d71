"""mfu.render: the configuration's frozen operations of one generator
window forward of one clip, times the real (unpadded) windows rendered a
second in the traced calls, over one card's float32 data-sheet peak.
Padding lowers it by design."""

from benchmark import yardstick as Y


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["window_s"]:
        return None
    flops = ctx["config"]["flops"]["window_forward_b1"] * ctx["real_windows"]
    return 100.0 * flops / trace["window_s"] / Y.PEAK_F32_FLOPS
