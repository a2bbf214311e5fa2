"""The system under test and its inputs, built from one configuration file
and the run's seed.

The program is reached only through its public entry points:
``conv.make_engine`` for the offline engines and ``conv.hybrid.HybridStream``
for the per-block real-time callback. Impulse responses and input audio are
the benchmark's own, made from the seed; the reference (``reference.py``)
takes them from here, never from the program.
"""

from __future__ import annotations

import math

import numpy as np

# engines driven through ``conv.make_engine``; "hybrid_stream" is the
# per-block ``HybridStream``
OFFLINE_ENGINES = ("nested", "hybrid", "chunked", "perblock")


def num_partitions(cfg: dict) -> int:
    return math.ceil(cfg["ir_seconds"] * cfg["sample_rate"] / cfg["block_size"])


def make_irs(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """[ir_channels, P*B] impulse responses, rounded to float32 (what the
    program is given): exponentially decaying noise, the shape of a real
    reverb tail, one independent draw per IR channel."""
    n = num_partitions(cfg) * cfg["block_size"]
    t = np.arange(n)
    env = 0.05 * np.exp(-t / (n / 4))
    irs = rng.standard_normal((cfg["ir_channels"], n)) * env
    return irs.astype(np.float32)


class System:
    """The program, configured. ``call(x)`` is the timed entry: [C, L]
    float32 audio in, [C, L] out (a device array for the offline engines,
    the stream's block for the callback)."""

    def __init__(self, cfg: dict, irs: np.ndarray):
        from neojax import conv

        self.cfg = cfg
        b = cfg["block_size"]
        parts = conv.uniform_partition(irs, b)  # [C', P, B+1] complex64
        engine = cfg["engine"]
        if engine in OFFLINE_ENGINES:
            self.engine = conv.make_engine(
                engine, parts, storage=cfg["storage"], scheme=cfg.get("scheme", "upols"),
                chunk_blocks=cfg.get("chunk_blocks"), channels=cfg["channels"],
            )
            self.call = self.engine.process
        elif engine == "hybrid_stream":
            from neojax.conv import hybrid

            pcfg = conv.PartitionedConfig(
                b, num_partitions(cfg), cfg["channels"], storage=cfg["storage"]
            )
            params = hybrid.hybrid_filter_params(pcfg, parts, cfg["chunk_blocks"])
            self.engine = hybrid.HybridStream(pcfg, params)
            self.call = self.engine
        else:
            raise ValueError(f"unknown engine {engine!r} in configuration "
                             f"{cfg.get('name')!r}")

    def refreshes(self, index: int) -> bool:
        """Whether call ``index`` (0-based from the stream's start) also runs
        the stream's chunk-rate tail refresh (``HybridStream.__call__``
        runs it after every S-th block)."""
        if self.cfg["engine"] != "hybrid_stream":
            return False
        return (index + 1) % self.cfg["chunk_blocks"] == 0


class Inputs:
    """The input stream: call ``j`` of the run (warm-up and prefill calls
    first) takes ``call(j)``, [C, L] float32 with L = blocks_per_call * B.

    ``device``: a pool of ``pool_calls`` distinct calls made on the device in
    one jitted call from the seed; call j takes pool[j % pool_calls].
    ``host``: contiguous host arrays made from the seed, a pool of
    ``pool_calls`` of them where the traffic names one, else one per call
    of the run (``calls``, known ahead only for an open loop).
    """

    def __init__(self, cfg: dict, traffic: dict, rng: np.random.Generator,
                 calls: int | None = None):
        import jax
        import jax.numpy as jnp

        c = cfg["channels"]
        self.length = traffic["blocks_per_call"] * cfg["block_size"]
        self.where = traffic["input"]
        if self.where == "device":
            pool = traffic["pool_calls"]
            key = jax.random.PRNGKey(int(rng.integers(0, 2**31 - 1)))
            gen = jax.jit(lambda k: tuple(
                jax.random.uniform(jax.random.fold_in(k, i), (c, self.length),
                                   jnp.float32, -1.0, 1.0)
                for i in range(pool)
            ))
            self._calls = list(jax.block_until_ready(gen(key)))
        elif self.where == "host":
            n = traffic.get("pool_calls", calls)
            if n is None:
                raise ValueError("host input of a closed loop needs pool_calls")
            # one contiguous [C, L] buffer per call, as a host hands it over
            self._calls = rng.uniform(-1.0, 1.0, (n, c, self.length)).astype(np.float32)
        else:
            raise ValueError(f"unknown input {self.where!r}")

    def call(self, j: int):
        return self._calls[j % len(self._calls)]

    def host_slice(self, ch: int, lo: int, hi: int) -> np.ndarray:
        """Samples [lo, hi) of channel ``ch`` of the whole stream as float64,
        zeros before its start."""
        out = np.zeros(hi - lo, np.float64)
        a = max(lo, 0)
        n = self.length
        pos = a
        while pos < hi:
            j, off = divmod(pos, n)
            end = min(hi, (j + 1) * n)
            seg = self.call(j)[ch, off : off + end - pos]
            out[pos - lo : end - lo] = np.asarray(seg, np.float64)
            pos = end
        return out
