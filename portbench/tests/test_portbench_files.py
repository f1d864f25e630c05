"""The benchmark is driven by files: every cell, configuration, traffic mix
and per-layer metric that BENCHMARK.json names is a file that the harness
finds by name, and a new one is found by adding a file."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["workloads", "configs"])
def test_every_named_file_is_there(bench, kind):
    for entry in bench[kind]:
        if kind == "workloads":
            cell, config, traffic = harness.load_cell(entry["name"])
            assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
                k: entry[k] for k in ("config", "traffic", "chips", "why")}
            assert cell["chips"] == 1 and len(cell["why"]) <= 200
            assert os.path.isfile(os.path.join(BENCH, "traffic", traffic["kind"] + ".py"))
            assert set(cell["limits"]) <= {"loss_gap", "grad_gap", "grad_gap_median",
                                           "change_gap", "change_gap_median", "mean_lsb",
                                           "max_lsb"}
        else:
            assert entry["file"] == f"portbench/configs/{entry['name']}.json"
            with open(os.path.join(ROOT, entry["file"])) as f:
                config = json.load(f)
            assert config["reduced"] == entry["reduced"] and config["source"] == entry["source"]
            for key in entry["reduced"]:
                assert key in config["published"]


def test_every_per_layer_metric_has_its_reader(bench):
    readers = harness.readers()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.LAYER, r.SOURCE, r.MOVES, r.BETTER) == (
            m["unit"], m["layer"], m["source"], m["moves"], m["better"])
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))


def test_a_new_cell_is_found_by_its_file(tmp_path):
    bench = str(tmp_path / "portbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(bench, "traffic", "train_s1_b128.json"), "w") as f:
        json.dump({"kind": "train_loop", "stage": 1, "batch": 128, "warmup_steps": 5,
                   "checked_steps": 3, "prefetch": 2}, f)
    with open(os.path.join(bench, "workloads", "throwaway.json"), "w") as f:
        json.dump({"config": "res64-bf16", "traffic": "train_s1_b128", "chips": 1,
                   "why": "a throwaway", "limits": {"grad_gap": 0.5}}, f)
    with open(os.path.join(bench, "metrics", "throwaway_ms.train.py"), "w") as f:
        f.write('UNIT = "ms"\nLAYER = "x"\nSOURCE = "host_clock"\nBETTER = "lower"\n'
                'MOVES = "train_images_per_s"\n\n\ndef read(ctx):\n    return 1.0\n')
    cell, config, traffic = harness.load_cell("throwaway", bench)
    assert traffic["batch"] == 128 and config["model"]["image_size"] == 64
    assert harness.traffic_kind(traffic["kind"], bench).run
    ctx = harness.Context("train")
    assert harness.per_layer(ctx, ["train_images_per_s"], bench)["throwaway_ms.train"] == {
        "value": 1.0, "unit": "ms"}
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no_such_cell", bench)


def test_configuration_builds_the_programs_config():
    from fmri_tpu_torch.configs.presets import get_config

    for name in ("res100-bf16", "res64-bf16"):
        _, config, _ = harness.load_cell("train_s1_res64")
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            config = json.load(f)
        cfg = harness.program_config(config, 256)
        assert cfg.model == get_config(name).model and cfg.train.batch_size == 256
