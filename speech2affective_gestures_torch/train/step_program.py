"""K GAN train steps as one program: the port's counterpart of the JAX
trainer's scanned epoch (`_get_multi_step`, train/trainer.py:338-394).

The body is the per-step loop's, K times: gather the batch of step j on
the device from the resident split (`ted_db.gather`, by the (K, B) row
indices and adversarial speakers the host drew), run `GanStep.train_step`
with the trimodal comparison on, and stack the step's metrics into a
(K, n_metrics) tensor.

On the card the body is captured once per (K, gan_on) into a
`torch.cuda.CUDAGraph` and replayed: one host->device copy of the indices
and one graph launch a program. What capture needs:
- both Adams capturable (`GanStep.make_capturable`): the update count and,
  with decay, the learning rate on the device, every state made before the
  capture;
- the step's `torch.Generator` registered with each graph, so that a
  replay draws what K eager steps draw and advances the generator by as
  much;
- a warm-up before each capture: one eager step on a side stream (cuBLAS
  and cuDNN handles, the GRU kernels' libraries, plans and launch
  checks), with everything that the step changes saved before it and put
  back after it, so that the warm-up trains nothing: the three nets'
  parameters and buffers, both Adam states and learning rates, the
  generator's state and the step count;
- the GRU and mel launch counters: a capture records launches and makes
  none, so the counts a capture adds are taken off again, kept as the
  graph's, and added at every replay (`launch_record`).
Replay raises if the capture did; nothing falls back to the eager body.
On a data-parallel mesh (`GanStep.mesh`, NCCL) the step's collectives
(the gradients' and metrics' all-reduces, BatchNorm's global sums, the
permutation's gather) are captured with it; the warm-up's eager
collectives set up the communicator first. The trainer hands each rank
its columns of the (K, B) draws.

On the CPU, which the tests use, the same body runs eagerly: with the same
draws in the same order it equals the per-step loop bit for bit.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..data.ted_db import DeviceDataset, gather, host_indices
from ..ops import gru_cuda, mel_cuda
from . import profiling
from .gan_step import GanStep

# every launch counter of the kernels a train step may run
COUNTERS = gru_cuda.COUNTERS + mel_cuda.COUNTERS


class _Graph:
    """One captured program: its graph, its static index buffer (2, K, B),
    its metric names and (K, n_metrics) output, and the launches one
    replay makes, by counter."""

    def __init__(self, graph, ids, keys, out, launches):
        self.graph, self.ids, self.keys, self.out = graph, ids, keys, out
        self.launches = launches
        self.replays = 0


class StepProgram:
    """K train steps of `step` on batches gathered from `data`, the noise
    and masks drawn from `generator`. `capture` (the default on a CUDA
    device) runs each (K, gan_on) as a captured graph; without it the body
    runs eagerly (on the card: the graph's K eager steps, with the same
    capturable Adams)."""

    def __init__(self, step: GanStep, data: DeviceDataset, generator: torch.Generator,
                 capture: bool | None = None):
        self.step, self.data, self.generator = step, data, generator
        self.device = data.device
        self.capture = self.device.type == "cuda" if capture is None else capture
        if self.capture and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {self.device}")
        if self.device.type == "cuda":
            step.make_capturable()
        self.graphs: dict[tuple[int, bool], _Graph] = {}
        # the launches of the warm-ups (eager, on the card), by kernel and
        # dtype
        self.warmup_launches = collections.Counter()

    def body(self, rows: torch.Tensor, vids: torch.Tensor, gan_on: bool):
        """The K steps on (K, B) row indices and speakers: (metric names,
        (K, n_metrics) tensor)."""
        out = []
        for j in range(rows.shape[0]):
            metrics = self.step.train_step(gather(self.data.arrays, rows[j], vids[j]),
                                           self.generator, gan_on=gan_on, tri_metric=True)
            out.append(metrics)
        keys = list(out[0])
        return keys, torch.stack([torch.stack([m[k] for k in keys]) for m in out])

    def run(self, idx: np.ndarray, adv: np.ndarray, gan_on: bool):
        """One program on the (K, B) host draws: (metric names, (K,
        n_metrics) tensor on the device, not yet read). The span
        `program.run` holds the ids' copy, the replay and the output's
        clone (or the eager body); the graph's launch, which waits there
        once the device's queue holds earlier replays, has the span
        `program.replay` of its own (`profiling.annotate`)."""
        if not self.capture:
            with profiling.annotate("program.run", self.step.step):
                rows, vids = self.data.indices(idx, adv)
                return self.body(rows, vids, gan_on)
        k = len(idx)
        graph = self.graphs.get((k, gan_on))
        if graph is None:
            graph = self.graphs[(k, gan_on)] = self._capture(idx, adv, gan_on)
        with profiling.annotate("program.run", self.step.step):
            graph.ids.copy_(host_indices(idx, adv), non_blocking=True)
            with profiling.annotate("program.replay"):
                graph.graph.replay()
            graph.replays += 1
            for counter, n in zip(COUNTERS, graph.launches):
                counter.update(n)
            self.step.step += k
            # the next replay rewrites the graph's output
            return graph.keys, graph.out.clone()

    # ------------------------------------------------------------ capture
    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step changes in place."""
        out = []
        for net in (self.step.gen, self.step.dis, self.step.tri):
            out += [t.detach() for t in net.parameters()] + list(net.buffers())
        for opt in (self.step.gen_opt, self.step.dis_opt):
            out += [v for s in opt.state.values() for v in s.values()
                    if isinstance(v, torch.Tensor)]
            out += [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
        return out

    def _capture(self, idx: np.ndarray, adv: np.ndarray, gan_on: bool) -> _Graph:
        ids = self.data.indices(idx, adv)
        tensors = self._state_tensors()
        saved = [t.clone() for t in tensors]
        generator_state, count = self.generator.get_state(), self.step.step
        before = [c.copy() for c in COUNTERS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.body(ids[0, :1], ids[1, :1], gan_on)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        self.generator.set_state(generator_state)
        self.step.step = count
        self.warmup_launches.update(_by_kernel([c - b for c, b in zip(COUNTERS, before)]))

        before = [c.copy() for c in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            keys, out = self.body(ids[0], ids[1], gan_on)
        launches = [c - b for c, b in zip(COUNTERS, before)]
        for c, b in zip(COUNTERS, before):
            c.clear()
            c.update(b)
        self.step.step = count
        return _Graph(graph, ids, keys, out, launches)

    def launch_record(self) -> dict:
        """{(K, gan_on): (launches of one replay by kernel and dtype,
        replays)}, from the graphs captured so far."""
        return {key: (_by_kernel(g.launches), g.replays) for key, g in self.graphs.items()}


def _by_kernel(counts: list) -> collections.Counter:
    """Of launch counts by counter (as `COUNTERS`), those by (kernel,
    dtype): the GRU kernels' and the mel kernel's."""
    return counts[0] + counts[len(gru_cuda.COUNTERS)]
