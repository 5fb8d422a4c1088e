"""The harness takes new data: a workload file and a metric file written into
a copy of the benchmark's folders are found and listed by its loader, with
no edit to its code."""

import json
import shutil

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.test_bench_reference import CELL
from benchmark.traffic import WARMUP, Traffic


def test_new_workload_and_metric_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "workloads" / "fem_b8.json").write_text(json.dumps(
        {"name": "fem_b8", "why": "a test mix", "batch": 8, "params_dtype": "float32"}))
    (bench / "metrics" / "wings_total.tet4.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    listed = harness.list_data(bench)
    assert "fem_b8" in listed["workloads"] and "fem_dataset" in listed["workloads"]
    assert "wings_total.tet4" in listed["metrics"]
    assert "wing_dof28k" in listed["configs"] and "tet4_stencil" in listed["drivers"]

    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    spec["workloads"].append({"name": "dof28k.fem_b8", "config": "wing_dof28k",
                              "traffic": "fem_b8", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "wings_total.tet4", "unit": "wings", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "tet4_wings_per_s", "workloads": ["dof28k.fem_b8"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and CELL in m["workloads"]:
            m["workloads"].append("dof28k.fem_b8")
    c = harness.load_cell("dof28k.fem_b8", spec, bench)
    assert c["traffic"]["batch"] == 8 and c["config"]["name"] == "wing_dof28k"
    assert [m["name"] for m in c["per_layer"]] == ["wings_total.tet4"]
    assert {m["name"] for m in c["end_to_end"]} == {"tet4_wings_per_s", "setup_s"}
    mod = harness.load_module("metrics", "wings_total.tet4", bench)
    assert mod.read(harness.Run(attempted=50)) == 50.0


def test_every_cell_names_files_that_exist():
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    listed = harness.list_data()
    for w in spec["workloads"]:
        c = harness.load_cell(w["name"], spec)
        assert c["config"]["driver"] in listed["drivers"]
        assert c["config"]["reference"] in listed["reference"]
        for m in c["end_to_end"] + c["per_layer"]:
            assert m["name"] in listed["metrics"], m["name"]
        assert c["per_layer"] and len(c["end_to_end"]) >= 2
    for cfg in spec["configs"]:
        assert (harness.ROOT / cfg["file"]).is_file()


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3 * 2**32 + 11, -5])
def test_traffic_is_dataset_generations_draw(seed):
    """Each wing drawn as generate_geometry_dataset.sample_params draws it, from
    a stream of (seed, batch) alone; the warm-up batch from a stream of its own."""
    from tpufem_torch.scripts.generate_geometry_dataset import sample_params

    c = harness.load_cell(CELL)
    gen = Traffic(c["traffic"], c["config"], seed)
    b1 = gen.batch(1)
    assert b1.shape == (c["traffic"]["batch"], 4) and b1.dtype == np.float32
    rng = np.random.default_rng([abs(seed), int(seed < 0), 0, 1])
    want = [list(sample_params(rng).as_dict().values()) for _ in range(len(b1))]
    assert np.array_equal(b1, np.asarray(want, np.float32))
    assert np.array_equal(Traffic(c["traffic"], c["config"], seed).batch(1), b1)
    assert not np.array_equal(gen.batch(WARMUP), gen.batch(0))
    assert not np.array_equal(gen.batch(0), b1)
