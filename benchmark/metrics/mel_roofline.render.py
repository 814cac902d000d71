"""mel_roofline.render: the mel kernel's frozen least time for the real
windows' frames of the traced calls (a real FFT of each frame, its power,
the filterbank's nonzeros; n_fft 2048, 128 bands, float32) over the mel
kernels' device time. Frames of padded windows are work the program adds
and count for nothing."""

import numpy as np

from benchmark import yardstick as Y
from benchmark.reference import synth


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not sum(ctx.get("mel_launches", {}).values()):
        return None
    spent = sum(s for name, s in trace["by_op"].items() if Y.kernel_family(name) == "mel")
    if spent <= 0:
        return None
    nnz = int(np.count_nonzero(synth.mel_filterbank(ctx["dims"]["audio_sr"], synth.N_FFT,
                                                     synth.N_MELS)))
    rows = ctx["real_windows"] * ctx["frames_per_window"]
    return 100.0 * Y.bound_s(*Y.mel_work(rows, synth.N_FFT, synth.N_MELS, nnz),
                             Y.PEAK_F32_FLOPS) / spent
