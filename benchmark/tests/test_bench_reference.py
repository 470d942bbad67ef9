"""The frozen reference (`refmodel`) agrees with the port on tiny configs
on the CPU, where the port runs its plain versions: every compared
reading of a run is 0, at the configurations' bf16 as at float32."""
import pytest

import run as bench_run
from harness import sides

import tiny

CELLS = ["magicpony.train", "fauna.train", "magicpony.recon"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("precision", ["bf16", "float32"])
def test_port_equals_reference(workload, precision):
    cell = tiny.cell(workload)
    cell.config = dict(cell.config, precision=precision)
    side = sides.Side("animals3d_tpu_torch",
                      precision=precision if precision == "bf16" else False)
    out = bench_run.run_cell(cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                             side=side)
    assert out["correct"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), \
        out["checks"]
