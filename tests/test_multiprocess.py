"""REAL 2-process ``jax.distributed`` cluster test.

Everything else distributed in the suite runs one process on a virtual
mesh; this spawns TWO OS processes that form an actual jax.distributed
cluster (local coordinator, 4 virtual CPU devices each, 8-device global
"ch" mesh), covering ``dist.multihost.init_distributed``'s multi-process
branch for the first time — plus mid-run host loss (os._exit) and
checkpoint resume across the process boundary via per-process sharded
checkpoints (``save_sharded_state``/``load_sharded_state``).

The final assertion: the crash-resumed distributed stream's outputs are
identical (1e-5, f32 reassociation across a different device split) to a
plain single-process ``cv.process`` run of the same stream.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(pid: int, coordinator: str, workdir: str, extra=()):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"  # CPU-only cluster: never opens a GPU
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, os.path.join(_REPO, "tests", "multiproc_worker.py"),
         str(pid), coordinator, workdir, *extra],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
    )


def _run_cluster(workdir: str, extra=()):
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [_launch(i, coordinator, workdir, extra) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    return procs, outs


@pytest.mark.slow
def test_two_process_cluster_kill_and_resume(tmp_path):
    workdir = str(tmp_path)

    # Run 1: workers die after chunk 5. The first death makes the
    # coordination service force-kill the peer wherever it happens to be
    # (a REAL asymmetric host loss: in practice one worker checkpoints
    # through chunk 5, the other through an earlier boundary).
    procs, outs = _run_cluster(workdir, ("--die-after", "6"))
    rcs = [p.returncode for p in procs]
    assert all(rc != 0 for rc in rcs), [o[1].decode()[-1000:] for o in outs]
    assert 17 in rcs, [o[1].decode()[-1000:] for o in outs]
    # The worker that chose to die had checkpointed through chunk 4; the
    # force-killed peer may be anywhere (possibly before its first save —
    # resume then replays its whole local stream, which is exact under
    # channel sharding).
    died = rcs.index(17)
    meta = os.path.join(workdir, f"ckpt_{died}.meta")
    assert os.path.exists(meta), "no checkpoint written before the crash"
    assert int(open(meta).read()) >= 4

    # Run 2: a fresh cluster; each process resumes from ITS OWN sharded
    # checkpoint (asymmetric replay — channel sharding has no collectives,
    # so replayed chunks recompute identical local outputs).
    procs, outs = _run_cluster(workdir)
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    # Assemble the distributed output from the per-chunk local shards.
    B, PARTS, C = 64, 8, 8
    CHUNK_BLOCKS, N_CHUNKS = 2, 8
    chunk_len = CHUNK_BLOCKS * B
    full = np.zeros((C, N_CHUNKS * chunk_len), np.float32)
    for i in range(N_CHUNKS):
        for pid in range(2):
            local = np.load(os.path.join(workdir, f"out_{pid}_{i}.npy"))
            lo = pid * (C // 2)
            full[lo : lo + C // 2, i * chunk_len : (i + 1) * chunk_len] = local

    # Single-process reference over the same stream.
    import jax.numpy as jnp
    from functools import partial
    import jax

    from neojax.conv import convolver as cv

    rng = np.random.default_rng(0)
    parts = (
        (rng.standard_normal((1, PARTS, B + 1))
         + 1j * rng.standard_normal((1, PARTS, B + 1))) * 0.1
    ).astype(np.complex64)
    sig = rng.uniform(-1, 1, (C, N_CHUNKS * chunk_len)).astype(np.float32)
    cfg = cv.PartitionedConfig(B, PARTS, C, storage="split")
    params = cv.filter_params(cfg, parts)
    state = cv.init_state(cfg)
    proc = jax.jit(partial(cv.process, cfg))
    outs_ref = []
    for i in range(N_CHUNKS):
        state, out = proc(
            params, state, jnp.asarray(sig[:, i * chunk_len : (i + 1) * chunk_len])
        )
        outs_ref.append(np.asarray(out))
    ref = np.concatenate(outs_ref, axis=-1)

    assert np.max(np.abs(full - ref)) < 1e-5
