#!/usr/bin/env python3
"""The control of the check that decides ``correct``, and the program's
readings beside it.

The configurations state float32 delay lines with exact (HIGHEST, true
f32) transforms. The nearest lower precision is ``HIGH``, which the H100
runs as TF32: the step that would tempt a later PR, since it is the
tensor-core path. The program has that path of its own (its int8 storage
runs its transforms at HIGH), so the control is the program with every
transform product (``fft.matmul_backend._matmul``, which the per-block
four-step transforms and the hybrid stream's block and meta transforms all
call) at HIGH, run through the same harness, at the cell's own size and
load. Its readings have to fail
the check: it sets the upper reading of each compared number, the program
the lower.

    python3 benchmark/control.py --workload <cell> --seeds 3 --seconds 20 [--program 12]

runs ``--seeds`` seeds of the control and ``--program`` seeds of the program
in one process, and prints one JSON line of their readings. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402


@contextlib.contextmanager
def transforms_at(precision):
    """Run every transform product of the program at ``precision`` (a
    ``jax.lax.Precision``), whatever precision its caller asks for."""
    from neojax.fft import matmul_backend

    orig = matmul_backend._matmul
    matmul_backend._matmul = lambda x, m, *_: orig(x, m, precision)
    try:
        yield
    finally:
        matmul_backend._matmul = orig


def readings(workload, seeds, seconds, control, require_gpu=True, **kw) -> list:
    """``check`` numbers of one run per seed."""
    from jax import lax

    out = []
    for seed in seeds:
        ctx = transforms_at(lax.Precision.HIGH) if control else contextlib.nullcontext()
        with ctx:
            res = run.run_cell(ROOT, workload, seed, seconds, False,
                               require_gpu=require_gpu, **kw)
        out.append({"seed": seed, "correct": res["correct"], **res["check"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--program", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    seeds = [args.first_seed + i for i in range(max(args.seeds, args.program))]
    try:
        res = {
            "control": readings(args.workload, seeds[: args.seeds], args.seconds, True),
            "program": readings(args.workload, seeds[: args.program], args.seconds, False),
        }
    except run.NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
