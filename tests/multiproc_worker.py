"""Worker for the REAL 2-process ``jax.distributed`` test.

Launched by ``tests/test_multiprocess.py`` as
``python tests/multiproc_worker.py <process_id> <coordinator> <workdir>
[--die-after N]``: forms a 2-process CPU cluster (4 virtual devices per
process, 8-device global "ch" mesh), streams a channel-sharded signal
through ``StreamDriver`` with per-process sharded checkpoints, writes
each chunk's LOCAL output shard to ``out_<pid>_<chunk>.npy``, and — on
the first run — dies mid-stream (os._exit, simulating host loss) so the
relaunch exercises checkpoint resume across a real process boundary.
"""

from __future__ import annotations

import os
import sys

# Must precede any jax import: CPU platform (never the GPU: one process
# per card), 4 virtual devices.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import numpy as np  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    coordinator = sys.argv[2]
    workdir = sys.argv[3]
    die_after = None
    if "--die-after" in sys.argv:
        die_after = int(sys.argv[sys.argv.index("--die-after") + 1])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from neojax.dist.multihost import (
        StreamDriver,
        init_distributed,
        load_sharded_state,
        save_sharded_state,
    )

    assert init_distributed(coordinator, num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    assert jax.device_count() == 8

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from functools import partial

    from neojax.conv import convolver as cv

    B, PARTS, C = 64, 8, 8
    CHUNK_BLOCKS, N_CHUNKS = 2, 8
    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("ch",))
    sh_ch = NamedSharding(mesh, P("ch"))
    sh_rep = NamedSharding(mesh, P())

    rng = np.random.default_rng(0)
    parts = (
        (rng.standard_normal((1, PARTS, B + 1)) + 1j * rng.standard_normal((1, PARTS, B + 1)))
        * 0.1
    ).astype(np.complex64)
    sig = rng.uniform(-1, 1, (C, N_CHUNKS * CHUNK_BLOCKS * B)).astype(np.float32)

    cfg = cv.PartitionedConfig(B, PARTS, C, storage="split")
    params_np = cv.filter_params(cfg, parts)
    state_np = cv.init_state(cfg)

    def to_global(x, sharding):
        x = np.asarray(x)
        if sharding is sh_rep or x.ndim == 0:
            return jax.make_array_from_process_local_data(sh_rep, x)
        return jax.make_array_from_process_local_data(sharding, x)

    params = jax.tree.map(lambda x: to_global(x, sh_rep), params_np)

    local_ch = C // 2
    lo, hi = pid * local_ch, (pid + 1) * local_ch

    def shard_state(leaf):
        leaf = np.asarray(leaf)
        # channel axis: tail [C, B] axis 0; fdl [2, P, C, K] axis 2
        if leaf.ndim == 2 and leaf.shape[0] == C:
            sh = NamedSharding(mesh, P("ch", None))
            return jax.make_array_from_process_local_data(sh, leaf[lo:hi])
        if leaf.ndim == 3 and leaf.shape[1] == C:  # dcny [P, C, 2]
            sh = NamedSharding(mesh, P(None, "ch", None))
            return jax.make_array_from_process_local_data(sh, leaf[:, lo:hi])
        if leaf.ndim == 4 and leaf.shape[2] == C:
            sh = NamedSharding(mesh, P(None, None, "ch", None))
            return jax.make_array_from_process_local_data(
                sh, leaf[:, :, lo:hi]
            )
        return jax.make_array_from_process_local_data(sh_rep, leaf)

    state = jax.tree.map(shard_state, state_np)
    proc = jax.jit(partial(cv.process, cfg))

    chunk_len = CHUNK_BLOCKS * B
    sh_sig = NamedSharding(mesh, P("ch", None))
    chunks = [
        jax.make_array_from_process_local_data(
            sh_sig, sig[lo:hi, i * chunk_len : (i + 1) * chunk_len]
        )
        for i in range(N_CHUNKS)
    ]

    # Warm-compile WITHOUT executing, then barrier: both processes enter
    # the stream together, so a simulated host loss at chunk k finds the
    # peer within a chunk or two of k (not still compiling).
    proc.lower(params, state, chunks[0]).compile()
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("neojax_stream_start")

    driver = StreamDriver(
        proc,
        checkpoint_path=os.path.join(workdir, f"ckpt_{pid}"),
        checkpoint_every=2,
        save_fn=save_sharded_state,
        load_fn=load_sharded_state,
    )

    for i, out, _state in driver.run(params, state, chunks):
        local = np.concatenate(
            [np.asarray(s.data) for s in sorted(
                out.addressable_shards, key=lambda s: s.index[0].start or 0
            )],
            axis=0,
        )
        np.save(os.path.join(workdir, f"out_{pid}_{i}.npy"), local)
        if die_after is not None and i + 1 >= die_after:
            sys.stderr.write(f"worker {pid}: simulating host loss at chunk {i}\n")
            sys.stderr.flush()
            os._exit(17)

    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
