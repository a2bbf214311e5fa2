"""The check fails a run whose timed path is broken underneath: the
harness's look for a chip is skipped, and the rest of a run is driven at a
tiny size with one fault planted in the program's call. One cell runs on
one chip, so there is no exchange between chips to leave out."""

import jax
import jax.numpy as jnp
import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT, SMALL


def state_unchanged(sut):
    """Each call returns its state unchanged: nothing carries between calls."""
    eng, call = sut.engine, sut.call

    def broken(x):
        saved = jax.tree.map(jnp.copy, eng.state)
        out = call(x)
        eng.state = saved
        return out

    sut.call = broken


def half_the_channels_left_out(sut):
    """Only the first half of the channels is computed; the rest reads 0."""
    call = sut.call

    def broken(x):
        out = call(x)
        return out.at[out.shape[0] // 2 :].set(0.0)

    sut.call = broken


def answer_altered(sut):
    """One sample of every call's output is altered where it is produced."""
    call = sut.call

    def broken(x):
        return call(x).at[:, 0].add(1.0)

    sut.call = broken


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", [state_unchanged, half_the_channels_left_out,
                                   answer_altered])
def test_fault_is_not_correct(workload, fault):
    cfg, traffic = SMALL[workload]
    res = run.run_cell(ROOT, workload, 2**31 + 99, 0.3, False, require_gpu=False,
                       fault=fault, overrides=cfg, traffic_overrides=traffic)
    assert res["correct"] is False
    assert res["check"]["rel_rms_err"]["value"] > res["check"]["rel_rms_err"]["limit"]
