"""The benchmark's files are found by name, and a configuration or a
traffic mix is added by new files and entries alone."""

import json
import re
import time

import pytest

from nftbench.harness.registry import BENCH_DIR, ROOT, Registry
from nftbench.harness.runner import run_cell
from nftbench.tests.tinytree import KEPT, tiny_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REG = Registry()
BENCH = REG.benchmark


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nftbench"]
    assert BENCH["command"] == ["python3", "nftbench/run.py"]
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[s]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    n_cells = 24   # the most a benchmark may hold: run_seconds must fit them
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * n_cells) * (rs + 60) + n_cells * 180 + 1200 <= 43200


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        reported = REG.metrics("end_to_end", w["name"])
        assert "setup_s" in [m["name"] for m in reported] and len(reported) > 1
        assert REG.metrics("per_layer", w["name"])


def _all(key):
    """The benchmark's entries and those of the cell kept for later."""
    return BENCH[key] + KEPT.get(key, [])


@pytest.mark.parametrize("config", [c["name"] for c in _all("configs")])
def test_config_loads(config):
    entry = next(c for c in _all("configs") if c["name"] == config)
    assert entry["file"].startswith("nftbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config
    if entry in BENCH["configs"]:
        assert cfg["reduced"] == entry["reduced"]
    assert len(entry["source"]) <= 200 and len(cfg["source"]) <= 200
    assert hasattr(REG.entry(cfg["entry"]), "build")
    ref = REG.reference(cfg["entry"])
    assert all(hasattr(ref, f) for f in ("plan", "expected", "observed",
                                         "compare"))


@pytest.mark.parametrize("workload", [w["name"] for w in _all("workloads")])
def test_workload_files_load(workload):
    cell = next(w for w in _all("workloads") if w["name"] == workload)
    assert cell["chips"] == 1
    traffic = REG.traffic(cell["traffic"])
    assert traffic["batch"] > 0 and traffic["pool"] >= 1
    assert callable(REG.family(traffic["family"]).make)
    limits = REG.limits(workload)
    assert set(limits) >= {"check", "limits"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(REG.reader(metric).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_reader_loads(metric):
    assert callable(REG.end_to_end(metric).read)


def test_kept_cell_stays_out_of_the_benchmark():
    names = {w["name"] for w in BENCH["workloads"]}
    assert not names & {w["name"] for w in KEPT["workloads"]}


def test_every_file_is_named_from_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


FAMILY = '''"""Traffic family of a test: Gaussian pulses of random phase."""

import math

import torch

from nftbench.harness.generate import grid


def make(traffic, cfg, g, device):
    t = grid(*cfg["t_span"], cfg["D"], device)
    phi = 2 * math.pi * torch.rand(traffic["batch"], 1, generator=g,
                                   device=device, dtype=torch.float64)
    q = traffic["amplitude"] * torch.exp(-t[None, :] ** 2 + 1j * phi)
    return {"q": q.contiguous(), "hints": {}}
'''

END_TO_END = '''"""Calls in the window, a test's metric."""


def read(w):
    return float(w.calls)
'''

READER = '''"""Calls in the traced window, a test's metric."""


def read(d):
    return float(d.calls)
'''


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic family and mix, a limits file, an
    end-to-end and a per-layer metric added as new files, with new entries
    in BENCHMARK.json, run without any edit of the files already there."""
    reg = tiny_tree(tmp_path)
    root = reg.root
    before = {p: p.read_bytes() for p in (root / "nftbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "nftbench/configs/nfdm_4096.json").read_text())
    cfg.update(name="nfdm_128", D=128, M=128)
    (root / "nftbench/configs/nfdm_128.json").write_text(json.dumps(cfg))
    (root / "nftbench/traffic/gauss.py").write_text(FAMILY)
    traffic = {"family": "gauss", "batch": 4, "pool": 2, "amplitude": 0.5,
               "warmup_s": 0.0, "trace_calls": 2}
    (root / "nftbench/traffic/gauss_b4.json").write_text(json.dumps(traffic))
    limits = json.loads((root / "nftbench/limits/nfdm_4096.rx_b1024.json"
                         ).read_text())
    limits["check"] = {"sample_xi": 8, "sample_rows": 2}
    (root / "nftbench/limits/nfdm_128.gauss_b4.json").write_text(
        json.dumps(limits))
    (root / "nftbench/end_to_end/calls_in_window.py").write_text(END_TO_END)
    (root / "nftbench/metrics/window.calls.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nfdm_128", "source": "a test",
                             "file": "nftbench/configs/nfdm_128.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "nfdm_128.gauss_b4",
                               "config": "nfdm_128", "traffic": "gauss_b4",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["nfdm_128.gauss_b4"]})
    bench["per_layer"].append({"name": "window.calls", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "a test", "moves": "calls_in_window",
                               "workloads": ["nfdm_128.gauss_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = Registry(root, root / "nftbench")
    res = run_cell("nfdm_128.gauss_b4", 5, 0.2, False, time.perf_counter(),
                   registry=new, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0
    assert set(res["metrics"]) == {"calls_in_window", "setup_s"}
    assert res["metrics"]["calls_in_window"]["value"] * 4 == res["attempted"]
    res = run_cell("nfdm_128.gauss_b4", 5, 0.2, True, time.perf_counter(),
                   registry=new, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["window.calls"]["value"] == 2
    for p, data in before.items():
        assert p.read_bytes() == data, p
