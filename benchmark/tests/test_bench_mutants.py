"""The comparison that decides `correct` catches a broken timed path: each
cell run at a tiny size on the CPU with the program broken underneath
reads `correct` false, under the cell's own limits. Faults: a GRU layer
with its two directions' recurrent weights swapped; a step that leaves the
state unchanged (no Adam update); half of each batch left out, the mean
taken over the rest; the frozen TriModal comparator's output altered, or
the comparator skipped; the gradients' exchange between ranks left out; a
clip's windows rendered out of order; an answer altered where it is
produced."""

import numpy as np
import pytest

from bench_tiny import cell_files, run_tiny, workloads

TRAIN = [w for w in workloads() if w.startswith("train.")]
RENDER = [w for w in workloads() if w.startswith("render.")]


def _swap_directions(patch):
    from speech2affective_gestures_torch.ops import gru_cuda

    plain = gru_cuda.gru_layer

    def swapped(xp, w_hh, b_ih, b_hh):
        return plain(xp, w_hh.flip(0).contiguous(), b_ih.flip(0).contiguous(),
                     b_hh.flip(0).contiguous())

    patch(gru_cuda, "gru_layer", swapped)


def _no_update(patch):
    from speech2affective_gestures_torch.train.gan_step import GanStep

    patch(GanStep, "_update", lambda self, who: None)


def _half_batch(patch):
    from speech2affective_gestures_torch.train.gan_step import GanStep

    step = GanStep.train_step

    def half(self, batch, *args, **kwargs):
        keep = len(batch["vec_seq"]) // 2
        return step(self, {k: v[:keep] for k, v in batch.items()}, *args, **kwargs)

    patch(GanStep, "train_step", half)


def _comparator_altered(patch):
    """The comparator run with the same draws, its output 1% off."""
    from speech2affective_gestures_torch.models.generator import PoseGeneratorTriModal

    forward = PoseGeneratorTriModal.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return (out[0] * 1.01, *out[1:])

    patch(PoseGeneratorTriModal, "forward", altered)


def _comparator_skipped(patch):
    """The comparator's output taken as the seed poses' first frames
    without running it: no dropout drawn, no work done."""
    from speech2affective_gestures_torch.models.generator import PoseGeneratorTriModal

    def skipped(self, pre_seq, *args, **kwargs):
        return (pre_seq[..., :-1].clone(), None, None, None)

    patch(PoseGeneratorTriModal, "forward", skipped)


def _no_exchange(patch):
    """The gradients' all-reduce left out (the metrics' and BatchNorm's
    collectives still run)."""
    from speech2affective_gestures_torch.parallel import mesh as P

    reduce = P.all_reduce_mean_

    def metrics_only(tensors, m):
        tensors = list(tensors)
        if tensors and tensors[0].dim() == 0:
            reduce(tensors, m)

    patch(P, "all_reduce_mean_", metrics_only)


def faulty_rank(mesh, job):
    """A data-parallel rank with the fault that job["traffic"]["fault"]
    names planted in it."""
    from benchmark.drivers import train

    RANK_FAULTS[job["traffic"]["fault"]](setattr)
    train.worker(mesh, job)


TRAIN_FAULTS = {"swapped_directions": _swap_directions, "no_update": _no_update,
                "half_batch": _half_batch, "comparator_altered": _comparator_altered,
                "comparator_skipped": _comparator_skipped}
RANK_FAULTS = {**TRAIN_FAULTS, "no_exchange": _no_exchange}


def _train_case(workload, fault, monkeypatch):
    """The cell run with `fault` planted: in this process, or in each rank
    of a data-parallel cell."""
    from benchmark.drivers import train

    if cell_files(workload)["traffic"]["ranks"] > 1:
        monkeypatch.setattr(train, "rank_main", faulty_rank)
        return run_tiny(workload, 77, False, traffic={"fault": fault})
    TRAIN_FAULTS[fault](monkeypatch.setattr)
    return run_tiny(workload, 77, False)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_reads_incorrect(workload, fault, monkeypatch):
    result, compared = _train_case(workload, fault, monkeypatch)
    assert result["correct"] is False, compared


@pytest.mark.parametrize("workload", [w for w in TRAIN
                                      if cell_files(w)["traffic"]["ranks"] > 1])
def test_exchange_left_out_reads_incorrect(workload, monkeypatch):
    result, compared = _train_case(workload, "no_exchange", monkeypatch)
    assert result["correct"] is False, compared


def _windows_out_of_order(patch):
    from speech2affective_gestures_torch.train import synthesis

    prepare = synthesis.prepare_window_inputs

    def reversed_windows(*args, **kwargs):
        audio, text, pad = prepare(*args, **kwargs)
        return audio[::-1].copy(), text[::-1].copy(), pad

    patch(synthesis, "prepare_window_inputs", reversed_windows)


def _answer_altered(patch):
    from speech2affective_gestures_torch.train import synthesis

    batched = synthesis.synthesize_clips_batched

    def altered(*args, **kwargs):
        out = batched(*args, **kwargs)
        i = int(np.argmax([len(dv) for dv, _ in out]))   # the longest, always compared
        dv, ps = out[i]
        out[i] = (dv + np.float32(0.01) * np.abs(dv).max(), ps)
        return out

    patch(synthesis, "synthesize_clips_batched", altered)


RENDER_FAULTS = {"swapped_directions": _swap_directions,
                 "windows_out_of_order": _windows_out_of_order,
                 "answer_altered": _answer_altered}


@pytest.mark.parametrize("workload", RENDER)
@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_render_fault_reads_incorrect(workload, fault, monkeypatch):
    RENDER_FAULTS[fault](monkeypatch.setattr)
    result, compared = run_tiny(workload, 79, False)
    assert result["correct"] is False, compared
