"""Analysis statistics used by the reference's user-study tooling.

Capability parity with `utils/common.py:27-70` (fleiss_kappa and the
sinusoid fit helper used in offline analyses; not in any training path).
"""

from __future__ import annotations

import numpy as np


def fleiss_kappa(ratings: np.ndarray) -> float:
    """Fleiss' kappa for an (N subjects, k categories) count matrix
    (ref utils/common.py:27-49)."""
    m = np.asarray(ratings, dtype=float)
    n_sub, _ = m.shape
    n_rat = m[0].sum()
    p_cat = m.sum(axis=0) / (n_sub * n_rat)
    p_sub = ((m**2).sum(axis=1) - n_rat) / (n_rat * (n_rat - 1))
    p_bar = p_sub.mean()
    p_e = (p_cat**2).sum()
    return float((p_bar - p_e) / (1.0 - p_e))


def fit_sinusoid(tt: np.ndarray, yy: np.ndarray) -> dict:
    """Least-squares sinusoid fit A*sin(w t + p) + c with FFT-based initial
    guess (ref utils/common.py:316-337 'fit_sin')."""
    import scipy.optimize as opt

    tt, yy = np.asarray(tt, float), np.asarray(yy, float)
    freqs = np.fft.fftfreq(len(tt), (tt[1] - tt[0]))
    fft_mag = abs(np.fft.fft(yy))
    guess_freq = abs(freqs[np.argmax(fft_mag[1:]) + 1])
    guess = np.array([np.std(yy) * 2.0**0.5, 2.0 * np.pi * guess_freq, 0.0,
                      np.mean(yy)])

    def sinfunc(t, a, w, p, c):
        return a * np.sin(w * t + p) + c

    popt, pcov = opt.curve_fit(sinfunc, tt, yy, p0=guess)
    a, w, p, c = popt
    return {
        "amp": a, "omega": w, "phase": p, "offset": c,
        "freq": w / (2.0 * np.pi), "period": 2.0 * np.pi / w,
        "fitfunc": lambda t: a * np.sin(w * t + p) + c,
        "maxcov": float(np.max(pcov)),
    }
