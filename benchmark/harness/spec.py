"""Finding what a cell is made of, by name: `BENCHMARK.json` at the root
of the checkout, the cell's file `workloads/<cell>.json`, its
configuration's file `configs/<config>.json`, each per-layer metric's
reader `metrics/<metric>.py` and the entry `harness/entries/<entry>.py`.
A new cell, configuration or metric is a new file; nothing here lists
them."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict        # workloads/<name>.json
    config: dict          # configs/<config>.json
    chips: int
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def entry(self):
        return importlib.import_module(
            f"harness.entries.{self.workload['entry']}")

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether `metric` is reported in `cell`: its `workloads` list names
    the cell or, without one, the cell reports its `moves` metric (or, for
    an end-to-end metric, every cell reports it)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric["moves"] in e2e_names


def load_cell(name: str, root: str = REPO, here: str = HERE) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _json(os.path.join(here, "workloads", name + ".json"))
    config = _json(os.path.join(here, "configs",
                                workload["config"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, workload, config, int(entries[name]["chips"]), e2e,
                per_layer)


def metric_reader(name: str, here: str = HERE):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
