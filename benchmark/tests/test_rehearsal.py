"""CPU rehearsal of the harness: each traffic drives a run end to end at a
tiny size; without a GPU, or without the program, ``run.py`` exits non-zero
and prints no result; a new cell is added by new files and one new
``workloads`` entry, with no existing file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT, SMALL


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_traffic_runs_end_to_end(workload, traced):
    cfg, traffic = SMALL[workload]
    res = run.run_cell(ROOT, workload, 2**31 + 7, 0.5, traced, require_gpu=False,
                       overrides=cfg, traffic_overrides=traffic)
    assert res["correct"] is True, res["check"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "check"
    assert res["check"]["rel_rms_err"]["value"] < res["check"]["rel_rms_err"]["limit"]
    spec = run.load_cell(ROOT, workload)
    names = {m["name"] for m in (spec["per_layer"] if traced else spec["end_to_end"])}
    assert set(res["metrics"]) <= names
    if not traced:  # every end-to-end metric is host-clocked, so the CPU has them
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "render64_ir10s_f32.device_io",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_a_gpu():
    p = _run_py(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no GPU" in p.stderr


def test_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


NEW_METRIC = '''
def read(trace, record):
    return float(len(record["window"].calls))
'''

# Traffic that a later cell may bring as a data file alone: each loop with
# each place its input comes from and its output goes to.
NEW_TRAFFIC = {
    "closed_device_io": {"loop": "closed", "blocks_per_call": 16, "input": "device",
                         "pool_calls": 2, "output": "device", "warmup_calls": 1,
                         "in_flight": 1, "kept_outputs": 2},
    "closed_host_io": {"loop": "closed", "blocks_per_call": 16, "input": "host",
                       "pool_calls": 3, "output": "host", "warmup_calls": 1,
                       "in_flight": 2, "kept_outputs": 2},
    "open_device_in_host_out": {"loop": "open", "blocks_per_call": 4, "input": "device",
                                "pool_calls": 2, "output": "host", "warmup_calls": 2,
                                "speed": 1.0, "deadline_periods": 10.0},
}


@pytest.mark.parametrize("traffic", sorted(NEW_TRAFFIC))
def test_new_cell_by_new_files_only(tmp_path, traffic):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs" / "render64_ir10s_f32.json").read_text())
    cfg.update(name="mono_ir1s_f32", channels=1, ir_seconds=0.02, block_size=32)
    (b / "configs" / "mono_ir1s_f32.json").write_text(json.dumps(cfg))
    (b / "traffic" / f"{traffic}.json").write_text(json.dumps(NEW_TRAFFIC[traffic]))
    (b / "metrics" / "calls_done.mono.py").write_text(NEW_METRIC)
    cell = f"mono_ir1s_f32.{traffic}"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mono_ir1s_f32", "source": "https://example.org",
                            "file": "benchmark/configs/mono_ir1s_f32.json",
                            "reduced": [], "why": "rehearsal"})
    spec["workloads"].append({"name": cell, "config": "mono_ir1s_f32",
                              "traffic": traffic, "chips": 1, "why": "rehearsal"})
    spec["end_to_end"][0]["workloads"].append(cell)
    spec["per_layer"].append({"name": "calls_done.mono", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "host entry",
                              "moves": "samples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in b.rglob("*") if p.is_file() and p in before}
    assert after == before  # nothing that existed was edited

    for traced in (False, True):
        res = run.run_cell(str(tmp_path), cell, 2**31 + 3, 0.3, traced, require_gpu=False)
        assert res["correct"] is True, res["check"]
        assert res["attempted"] > 0 and res["failed"] == 0
        if traced:
            assert set(res["metrics"]) == {"calls_done.mono"}
            assert res["metrics"]["calls_done.mono"]["value"] == res["attempted"]
        else:
            assert set(res["metrics"]) == {"samples_per_s", "setup_s"}
