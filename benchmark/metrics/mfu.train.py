"""mfu.train: the configuration's frozen operations of one train step at
512 rows a card, times the traced sub-window's steps a second, over one
card's data-sheet peak for the cell's precision (float32 67e12, mixed
precision the bf16 989e12)."""

from benchmark import yardstick as Y


def read(ctx):
    trace, traffic = ctx.get("trace"), ctx["traffic"]
    if not trace or not trace["window_s"] or traffic["batch_per_rank"] != 512:
        return None
    peak = Y.PEAK_BF16_FLOPS if traffic["precision"] == "mixed" else Y.PEAK_F32_FLOPS
    flops = ctx["config"]["flops"]["train_step_b512"] * ctx["steps"]
    return 100.0 * flops / trace["window_s"] / peak
