"""The card's identity, and its SM clock and power draw sampled beside the
window by an ``nvidia-smi`` child process (it stays off JAX, so it takes
nothing from the run's host path but a pipe read)."""

from __future__ import annotations

import statistics
import subprocess
import threading


def card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown card ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


class Sampler:
    """``with Sampler() as s: ...`` samples every ``interval_ms``; then
    ``s.summary()``."""

    def __init__(self, interval_ms: int = 500):
        self.interval_ms = interval_ms
        self.samples: list[tuple[float, float]] = []  # (MHz, W)
        self._proc = None
        self._thread = None

    def __enter__(self):
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-i", "0",
                 "-lms", str(self.interval_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            )
        except OSError:
            return self
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self):
        for line in self._proc.stdout:
            try:
                mhz, watts = (float(v) for v in line.split(",")[:2])
            except ValueError:
                continue
            self.samples.append((mhz, watts))

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._thread.join(timeout=10)
        return False

    def summary(self) -> str:
        if not self.samples:
            return "no nvidia-smi samples"
        mhz = [m for m, _ in self.samples]
        watts = [w for _, w in self.samples]
        return (f"{len(self.samples)} samples: SM clock median "
                f"{statistics.median(mhz)} MHz (min {min(mhz)}, max {max(mhz)}), "
                f"power median {statistics.median(watts)} W (max {max(watts)})")
