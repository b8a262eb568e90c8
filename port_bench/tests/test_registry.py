"""A cell, a configuration, a traffic mix and a metric added as files are
found by name, with no edit to the harness."""

import json
import os
import shutil

import pytest

from port_bench import registry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_new_files_are_found(tmp_path):
    base = tmp_path / "port_bench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = registry.benchmark()
    cfg = registry.config("gpt2_medium")
    cfg["name"] = "gpt2_medium_copy"
    (base / "configs" / "gpt2_medium_copy.json").write_text(json.dumps(cfg))
    tr = registry.traffic("lm_packed_b32s1024")
    tr["name"] = "lm_packed_b16s1024"
    tr["global_rows"] = 16
    (base / "traffic" / "lm_packed_b16s1024.json").write_text(
        json.dumps(tr))
    wl = registry.workload("gpt2_medium_lm_b32s1024")
    wl.update(name="gpt2_medium_copy_b16", config="gpt2_medium_copy",
              traffic="lm_packed_b16s1024")
    (base / "workloads" / "gpt2_medium_copy_b16.json").write_text(
        json.dumps(wl))
    (base / "metrics" / "steps_run.py").write_text(
        "def read(ctx):\n    return float(len(ctx))\n")
    bench["workloads"].append({"name": "gpt2_medium_copy_b16",
                               "config": "gpt2_medium_copy",
                               "traffic": "lm_packed_b16s1024", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_run", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "input", "moves":
                               "train_samples_per_s",
                               "workloads": ["gpt2_medium_copy_b16"]})
    entry, w, c, t = registry.resolve(bench, "gpt2_medium_copy_b16",
                                      base=str(base))
    assert c["name"] == "gpt2_medium_copy" and t["global_rows"] == 16
    assert w["traffic"] == "lm_packed_b16s1024"
    names = [m["name"] for m in registry.metrics_for(
        bench, "gpt2_medium_copy_b16", "per_layer")]
    assert "steps_run" in names and "allreduce_exposed_ms" not in names
    assert registry.metric_reader("steps_run", base=str(base))([1, 2]) == 2


def test_every_listed_metric_has_a_reader():
    bench = registry.benchmark()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(registry.metric_reader(m["name"]))


def test_workload_must_agree_with_benchmark():
    bench = registry.benchmark()
    bench = json.loads(json.dumps(bench))
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError):
        registry.resolve(bench, bench["workloads"][0]["name"])
