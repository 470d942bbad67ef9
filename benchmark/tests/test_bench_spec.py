"""Every cell, configuration and metric of BENCHMARK.json is found by its
name, and a new file is taken as data with no edit of the harness."""
import json
import os
import shutil

import pytest

from harness import spec

BENCH = json.load(open(os.path.join(spec.REPO, "BENCHMARK.json")))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = spec.load_cell(name)
    entry = [w for w in BENCH["workloads"] if w["name"] == name][0]
    assert cell.workload["config"] == entry["config"]
    assert cell.chips == entry["chips"] == cell.workload["chips"]
    assert cell.config["name"] == entry["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert hasattr(cell.entry, "setup") and hasattr(cell.entry, "check")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(name):
    read = spec.metric_reader(name)
    assert read({"entry": "none"}) is None


@pytest.mark.parametrize("cfg", BENCH["configs"])
def test_config_file(cfg):
    data = json.load(open(os.path.join(spec.REPO, cfg["file"])))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], \
                (m["name"], w)


def test_new_files_are_data(tmp_path):
    """A copy of the benchmark with one more cell and one more metric,
    each a new file: both are found with no edit of the harness."""
    here = tmp_path / "benchmark"
    for sub in ("workloads", "configs", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    bench = json.loads(json.dumps(BENCH))
    w = json.load(open(here / "workloads" / "magicpony.train.json"))
    w["iteration"] = 70000
    json.dump(w, open(here / "workloads" / "magicpony.train_late.json", "w"))
    bench["workloads"].append({"name": "magicpony.train_late",
                               "config": "magicpony_horse",
                               "traffic": "train_late", "chips": 1,
                               "why": "a later phase"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("magicpony.train_late")
    (here / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return ctx['trace']['steps']\n")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "Device", "moves": "train_imgs_per_s",
                               "workloads": ["magicpony.train_late"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = spec.load_cell("magicpony.train_late", root=str(tmp_path),
                          here=str(here))
    assert cell.workload["iteration"] == 70000
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    assert "train_imgs_per_s" in [m["name"] for m in cell.end_to_end]
    read = spec.metric_reader("steps_traced", here=str(here))
    assert read({"trace": {"steps": 3}}) == 3


def test_leaves_group_by_trained_module():
    from harness import compare
    assert compare.module_of("netBase.netSDF.mlp.layer_2.weight") == \
        "netBase.netSDF"
    assert compare.module_of("netInstance.netPose.conv_out.weight") == \
        "netInstance.netPose"
    assert compare.module_of("netBase.memory_bank_keys") == "netBase"
    assert compare.module_of("netDisc.conv_0.weight") == "netDisc"
    mods = compare.by_module({"netBase.netSDF.a": 0.1,
                              "netBase.netSDF.b": 0.3,
                              "netBase.netSDF.c": 0.2,
                              "netInstance.netPose.a": 0.5})
    assert mods["netBase.netSDF"]["median"] == 0.2
    assert mods["netBase.netSDF"]["worst"] == 0.3
    assert mods["netBase.netSDF"]["n"] == 3
    assert mods["netInstance.netPose"]["worst_leaf"] == \
        "netInstance.netPose.a"
