"""Everything a cell needs, found by name: ``BENCHMARK.json`` at the root
of the checkout, configurations by their ``file``, traffic mixes in
``nftbench/traffic/<traffic>.json`` and the generator of the family a mix
names in ``nftbench/traffic/<family>.py``, limits in
``nftbench/limits/<workload>.json``, the entry and the reference of a
configuration's ``entry`` kind in ``nftbench/entries/<entry>.py`` and
``nftbench/reference/<entry>.py``, each end-to-end metric's reader in
``nftbench/end_to_end/<metric>.py`` and each per-layer metric's reader in
``nftbench/metrics/<metric>.py``. Adding any of these is adding a file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.benchmark = load_json(self.root / "BENCHMARK.json")

    def cell(self, workload: str) -> dict:
        for cell in self.benchmark["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.bench_dir / "traffic" / f"{name}.json")

    def family(self, name: str):
        return _load(self.bench_dir / "traffic" / f"{name}.py")

    def limits(self, workload: str) -> dict:
        return load_json(self.bench_dir / "limits" / f"{workload}.json")

    def metrics(self, section: str, workload: str) -> list:
        """The entries of ``section`` ("end_to_end" or "per_layer") that
        the workload reports."""
        return [m for m in self.benchmark[section]
                if workload in m.get("workloads", [workload])]

    def entry(self, kind: str):
        return _load(self.bench_dir / "entries" / f"{kind}.py")

    def reference(self, kind: str):
        return _load(self.bench_dir / "reference" / f"{kind}.py")

    def end_to_end(self, metric: str):
        return _load(self.bench_dir / "end_to_end" / f"{metric}.py")

    def reader(self, metric: str):
        return _load(self.bench_dir / "metrics" / f"{metric}.py")


def _load(path: Path):
    """The module in ``path``, under the package ``nftbench`` where it lies
    in this checkout's tree, else by file (a name with dots)."""
    if not path.exists():
        raise FileNotFoundError(path)
    if path.is_relative_to(BENCH_DIR):
        rel = path.relative_to(BENCH_DIR.parent).with_suffix("")
        if all(p.isidentifier() for p in rel.parts):
            return importlib.import_module(".".join(rel.parts))
    name = "nftbench_file_" + re.sub(r"\W", "_", str(path.with_suffix("")))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_patterns(reader_file: str) -> list:
    """The device kernel names a reader sums: regular expressions, one a
    line, in every ``<metric>.names*.txt`` beside the reader (a kernel that
    replaces another adds a file of its own)."""
    path = Path(reader_file)
    pats = []
    for f in sorted(path.parent.glob(f"{path.stem}.names*.txt")):
        lines = f.read_text().splitlines()
        pats += [re.compile(x.strip()) for x in lines
                 if x.strip() and not x.startswith("#")]
    return pats
