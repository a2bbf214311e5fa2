"""The plain reference and the comparison that decides ``correct``.

Every engine of the program computes a uniformly partitioned convolution
of its input with the impulse response, which is the linear convolution
y[n] = sum_m h[m] x[n - m] of the stream since its start. The reference
computes that in float64 with numpy's FFT, from the benchmark's own input
and IR (``system.py``); it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np


def convolve_valid(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """The outputs y[len(h)-1 :] of the linear convolution of ``x`` with
    ``h``: those whose whole history lies inside ``x``. float64."""
    x = np.asarray(x, np.float64)
    h = np.asarray(h, np.float64)
    n = x.size + h.size - 1
    nfft = 1 << (n - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft)
    return y[h.size - 1 : x.size]


def stream_output(inputs, h: np.ndarray, ch: int, lo: int, hi: int) -> np.ndarray:
    """Reference output samples [lo, hi) of channel ``ch`` of the stream
    that ``inputs`` (``system.Inputs``) feeds, with impulse response ``h``."""
    x = inputs.host_slice(ch, lo - (h.size - 1), hi)
    return convolve_valid(x, h)


class Comparison:
    """Accumulates (program, reference) pairs; the number compared is the
    relative RMS error sqrt(sum err^2 / sum ref^2) over all of them, held
    to the configuration's SNR class: 10^(-class_db / 20)."""

    def __init__(self, snr_class_db: float):
        self.limit = 10.0 ** (-snr_class_db / 20.0)
        self.class_db = snr_class_db
        self.err2 = 0.0
        self.ref2 = 0.0
        self.max_abs = 0.0
        self.samples = 0
        self.missing = 0

    def add(self, got, ref) -> None:
        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            raise ValueError(f"output shape {got.shape} != reference {ref.shape}")
        err = got - ref
        if not np.all(np.isfinite(err)):
            self.err2 = math.inf
        else:
            self.err2 += float(np.sum(err * err))
            self.max_abs = max(self.max_abs, float(np.max(np.abs(err), initial=0.0)))
        self.ref2 += float(np.sum(ref * ref))
        self.samples += ref.size

    def add_missing(self, n: int = 1) -> None:
        """An answer that never came."""
        self.missing += n

    @property
    def rel_rms_err(self) -> float:
        if self.ref2 == 0.0:
            return math.inf
        return math.sqrt(self.err2 / self.ref2)

    @property
    def correct(self) -> bool:
        return self.missing == 0 and self.samples > 0 and self.rel_rms_err <= self.limit

    def numbers(self) -> dict:
        """Each number compared, beside its limit (a number that is not
        finite reads as null)."""
        r = self.rel_rms_err
        return {
            "rel_rms_err": {"value": r if math.isfinite(r) else None, "limit": self.limit},
            "missing_outputs": {"value": self.missing, "limit": 0},
        }

    def summary(self) -> str:
        r = self.rel_rms_err
        snr = -20.0 * math.log10(r) if 0 < r < math.inf else (math.inf if r == 0 else -math.inf)
        return (f"{self.samples} samples compared: SNR {snr:.3f} dB against the f64 "
                f"reference (class {self.class_db} dB), max abs error {self.max_abs:.6g}")
