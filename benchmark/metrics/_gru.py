"""What gru_roofline.train and gru_roofline.render share: the frozen
least time of the GRU kernel calls that the program counted in the traced
sub-window (`gru_cuda.shape_launches` by (kernel, dtype, T, H) and
`batch_launches` by (kernel, dtype, B, H, tier)), over those kernels'
device time."""

import collections

from benchmark import yardstick as Y


def calls(ctx, kernels):
    """[(kernel, dtype, T, B, H, count)] of the counted calls, or None
    where a (kernel, dtype, H) ran at several T and several B at once, so
    that the pairs are not known."""
    by_t, by_b = collections.defaultdict(collections.Counter), \
        collections.defaultdict(collections.Counter)
    for (kernel, dtype, t, h), n in ctx["shape_launches"].items():
        if kernel in kernels and n > 0:
            by_t[(kernel, dtype, h)][t] += n
    for (kernel, dtype, b, h, _tier), n in ctx["batch_launches"].items():
        if kernel in kernels and n > 0:
            by_b[(kernel, dtype, h)][b] += n
    out = []
    for key, ts in by_t.items():
        bs = by_b.get(key, collections.Counter())
        if len(ts) == 1:
            (t,) = ts
            out += [(*key[:2], t, b, key[2], n) for b, n in bs.items()]
        elif len(bs) == 1:
            (b,) = bs
            out += [(*key[:2], t, b, key[2], n) for t, n in ts.items()]
        else:
            return None
    return out


def roofline(ctx, kernels):
    trace = ctx.get("trace")
    if not trace:
        return None
    found = calls(ctx, kernels)
    if not found:
        return None
    least = sum(n * Y.bound_s(*Y.gru_work(k, dtype, t, b, h)) for k, dtype, t, b, h, n in found)
    spent = sum(s for name, s in trace["by_op"].items() if Y.kernel_family(name) in kernels)
    if spent <= 0:
        return None
    return 100.0 * least / spent
