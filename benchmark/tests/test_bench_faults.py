"""The comparison fails what it must: a run driven through the harness on
the CPU at a tiny size, with the timed path broken underneath, comes out
not correct; so does the control, the reference in float8 put in the
program's place. The chip's look for a card is skipped: these drive
`run_cell` directly.

The limits here are the cell's own, from its workload file: each fault
moves its reading far past them."""
import pytest

import run as bench_run
from harness import faults, sides

import tiny

SEED = 2 ** 31 + 5


def _run(workload, side):
    cell = tiny.cell(workload)
    return bench_run.run_cell(cell, SEED, 0.5, False, device="cpu",
                              side=side)


@pytest.mark.parametrize("workload,kind", [
    ("magicpony.train", "unchanged"), ("magicpony.train", "halfbatch"),
    ("magicpony.train", "sdfzero"),
    ("fauna.train", "unchanged"), ("fauna.train", "halfbatch"),
    ("fauna.train", "sdfzero"), ("fauna.train", "sdfscaled"),
    ("magicpony.train_fine", "unchanged"),
    ("magicpony.train_fine", "halfbatch"),
    ("magicpony.train_fine", "sdfzero"), ("magicpony.recon", "altered")])
def test_fault_is_not_correct(workload, kind):
    out = _run(workload, faults.planted(kind))
    assert out["correct"] is False, out["checks"]


def test_unchanged_state_reads_one():
    out = _run("magicpony.train", faults.planted("unchanged"))
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert out["detail"]["grad"]["median"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload,kind,factor", [
    ("magicpony.train", "sdfzero", 0.0), ("magicpony.train", "sdfscaled", 2.0),
    ("fauna.train", "sdfscaled", 2.0)])
def test_sdf_fault_reads_in_netsdf_alone(workload, kind, factor):
    """netSDF's gradient zeroed or doubled: each netSDF leaf's first
    gradient reads |factor - 1| of its norm (over the larger of its norm
    and the median leaf's), while the median leaf of all of them, outside
    netSDF, does not move."""
    out = _run(workload, faults.planted(kind))
    mods = out["detail"]["modules"]
    sdf = mods["netBase.netSDF"]
    assert sdf["grad"] == pytest.approx(abs(factor - 1.0), abs=0.05)
    assert out["detail"]["grad"]["median"] < 0.05
    if factor == 0.0:
        assert sdf["change"] > 0.5


@pytest.mark.parametrize("workload", ["magicpony.train", "fauna.train",
                                      "magicpony.train_fine",
                                      "magicpony.recon"])
def test_control_reads_far_above_float32(workload):
    """The float8 control in the program's place fails the cell's limits
    (the port itself reads 0 here: `test_bench_reference.py`)."""
    control = _run(workload, sides.Side("refmodel", precision="fp8",
                                        name="control"))
    assert control["correct"] is False, control["checks"]
