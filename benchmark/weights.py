"""Weights made from the seed on the device, for both the program and the
plain reference: one uniform draw over every tensor of the nets' state
dicts from a `torch.Generator` on the device, scaled per tensor as torch's
default initialization scales it, in a few large calls."""

from __future__ import annotations

import math

import torch


def _scale_offset(name: str, shape: tuple, shapes: dict, tables: set, bn: set):
    """(scale, offset) of a tensor drawn as U(-1, 1) * scale + offset."""
    prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if prefix in bn:
        return {"weight": (0.1, 1.0), "bias": (0.1, 0.0), "running_mean": (0.1, 0.0),
                "running_var": (0.5, 1.0)}[leaf]
    if leaf.startswith(("weight_ih", "weight_hh", "bias_ih", "bias_hh")):
        hidden = shapes[f"{prefix}.weight_hh_l0" if prefix else "weight_hh_l0"][1]
        return 1.0 / math.sqrt(hidden), 0.0
    if name in tables:
        return math.sqrt(3.0), 0.0
    if leaf == "bias":
        w = shapes.get(f"{prefix}.weight", shapes.get(f"{prefix}.weight_v"))
        return 1.0 / math.sqrt(math.prod(w[1:])), 0.0
    return (1.0 / math.sqrt(math.prod(shape[1:])) if len(shape) > 1 else 1.0), 0.0


def make_state(module: torch.nn.Module, seed: int, device) -> dict:
    """{name: tensor} for every entry of `module`'s state dict (its shapes
    only are read; `num_batches_tracked` is zero): U(-1, 1) times
    1/sqrt(fan_in) for weights and biases (a recurrent net's by its hidden
    size), unit variance for embedding tables, BatchNorm scales 1 +
    U(-0.1, 0.1) and shifts U(-0.1, 0.1), running means U(-0.1, 0.1) and
    variances 1 + U(-0.5, 0.5), and weight-norm gains the norm of their
    direction tensors. A tensor held under two names gets one value."""
    state = module.state_dict(keep_vars=True)
    first = {}
    aliases = {k: first.setdefault(id(v), k) for k, v in state.items()}
    shapes = {k: tuple(v.shape) for k, v in state.items() if aliases[k] == k}
    tables = {f"{n}.weight" for n, m in module.named_modules()
              if isinstance(m, torch.nn.Embedding)}
    bn = {k.rsplit(".", 1)[0] for k in shapes if k.endswith("running_mean")}
    floats = [k for k in shapes if not k.endswith("num_batches_tracked")]
    counts = [math.prod(shapes[k]) for k in floats]
    so = torch.tensor([_scale_offset(k, shapes[k], shapes, tables, bn) for k in floats],
                      device=device)
    reps = torch.tensor(counts, device=device)
    total = sum(counts)
    scale = torch.repeat_interleave(so[:, 0], reps, output_size=total)
    offset = torch.repeat_interleave(so[:, 1], reps, output_size=total)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = (torch.rand(total, generator=g, device=device) * 2.0 - 1.0) * scale + offset
    out = {k: p.view(shapes[k]) for k, p in zip(floats, torch.split(flat, counts))}
    for name in floats:
        if name.endswith("weight_g"):
            out[name] = out[name[:-1] + "v"].flatten(1).norm(dim=1).view(-1, 1, 1)
    for name in shapes:
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    return {k: out[a] for k, a in aliases.items()}
