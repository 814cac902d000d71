"""The comparison that decides `correct`: the numbers that hold what the
timed path produced against the plain reference, each beside its limit
(benchmark/limits/<cell>.json)."""

from __future__ import annotations

import math
import statistics

import numpy as np

# the step metrics compared, under the program's names
LOSS_KEYS = ("dis", "loss", "DIV_REG", "KLD", "gen", "g_total", "s2ag_l1")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def _gap(p: float, r: float, scale: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), scale)


def _per_step(prog: dict, ref: dict, gap) -> list[float]:
    """gap(program's metrics, reference's) at each followed step; [inf]
    where the two followed different numbers of steps."""
    if len(prog["losses"]) != len(ref["losses"]) or not ref["losses"]:
        return [math.inf]
    return [gap(p, r) for p, r in zip(prog["losses"], ref["losses"])]


def _loss_gap(p: dict, r: dict) -> float:
    return max(_gap(p.get(k, math.nan), r[k], 1e-6) for k in LOSS_KEYS)


def _tri_gap(p: dict, r: dict) -> float:
    """The frozen TriModal comparator's own term, tri_l1 = s2ag_l1 -
    s2ag_vs_trimodal_l1 (its output's L1 to the target), against the
    larger of the reference's tri_l1 and s2ag_l1."""
    def tri(m):
        return m.get("s2ag_l1", math.nan) - m.get("s2ag_vs_trimodal_l1", math.nan)

    return _gap(tri(p), tri(r), abs(r["s2ag_l1"]))


def _leaf_gaps(pv: dict, rv: dict, leaves) -> list[tuple[float, str]]:
    """(gap, leaf) of each leaf, worst first: the gap between the two
    sides' norms against the larger of the reference's norm of that leaf
    and of the median leaf."""
    leaves = list(leaves)
    if not leaves:
        return [(math.inf, "")]
    med = statistics.median(rv[k] for k in leaves)
    return sorted(((_gap(pv.get(k, math.nan), rv[k], max(med, 1e-30)), k) for k in leaves),
                  reverse=True)


def _moving(ref: dict) -> list[str]:
    med_g = statistics.median(ref["grad"].values())
    return [k for k in ref["delta"] if ref["grad"].get(k, 0.0) >= STILL_LEAF * med_g]


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap_first: the widest relative gap of a step metric at the
    first step, before any update has had its rounding amplified;
    loss_gap: the same over all the followed steps; tri_gap: the
    comparator's term at every followed step; grad_gap: the worst leaf's
    gap between the norms of the first gradient (or first moment) on the
    two sides; delta_gap: the same of the parameters' change over the
    followed steps, the still leaves left out."""
    steps = _per_step(prog, ref, _loss_gap)
    return {"loss_gap_first": steps[0], "loss_gap": max(steps),
            "tri_gap": max(_per_step(prog, ref, _tri_gap)),
            "grad_gap": _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])[0][0],
            "delta_gap": _leaf_gaps(prog["delta"], ref["delta"], _moving(ref))[0][0]}


def render_numbers(got: list, want: list) -> dict:
    """dir_vec_gap: over every compared clip, the largest |program -
    reference| of its direction vectors against the reference's largest
    magnitude of that clip; a clip of the wrong length reads inf."""
    gap = 0.0
    for p, r in zip(got, want):
        if p.shape != r.shape or not np.all(np.isfinite(p)):
            return {"dir_vec_gap": math.inf}
        gap = max(gap, float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-6)))
    return {"dir_vec_gap": gap}


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: (number, limit)}) over the numbers the cell's limits
    name: a number without an upper reading is not compared."""
    compared = {k: (numbers[k], lim) for k, lim in limits.items()}
    return all(v <= lim for v, lim in compared.values()), compared


def train_detail(prog: dict, ref: dict) -> dict:
    """What the limits are set from, beside `train_numbers`: each step's
    widest loss gap and comparator gap, the median leaf's gaps, and the
    worst leaves with their norms over the median leaf's."""
    out = {"loss_gap_by_step": _per_step(prog, ref, _loss_gap),
           "tri_gap_by_step": _per_step(prog, ref, _tri_gap)}
    for name, keys in (("grad", list(ref["grad"])), ("delta", _moving(ref))):
        gaps = _leaf_gaps(prog[name], ref[name], keys)
        med = statistics.median(ref[name][k] for k in keys)
        out[f"{name}_gap_median"] = statistics.median(g for g, _ in gaps)
        out[f"{name}_worst"] = [[k, g, ref[name][k] / med] for g, k in gaps[:3]]
    return out
