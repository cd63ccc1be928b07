"""A copy of the benchmark's files with each configuration, traffic mix and
check cut to the size its own file names under ``cpu_test`` (and
``cpu_test_check``), which the CPU runs in seconds.

The copy's ``BENCHMARK.json`` also lists the full NFT's cell
(``nsev_65536.full_b128``), which the benchmark leaves out until the
program's host-paced Newton-polygon starts are replaced: its
configuration, traffic, limits, entry and reference stay in ``nftbench/``
and are tested here.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from nftbench.harness.registry import BENCH_DIR, ROOT, Registry

KEPT = {
    "configs": [{"name": "nsev_65536", "source": "FNFT's sech test",
                 "file": "nftbench/configs/nsev_65536.json",
                 "reduced": [], "why": "the full NFT"}],
    "workloads": [{"name": "nsev_65536.full_b128", "config": "nsev_65536",
                   "traffic": "sech_b128", "chips": 1,
                   "why": "the full NFT of 128 sech signals"}],
}


def _shrink(path: Path, key: str, into: str | None = None) -> None:
    data = json.loads(path.read_text())
    if into is None:
        data.update(data.get(key, {}))
    elif key in data:
        data[into] = data[key]
    path.write_text(json.dumps(data))


def tiny_tree(dst: Path) -> Registry:
    dst = Path(dst)
    shutil.copytree(BENCH_DIR, dst / "nftbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in KEPT.items():
        bench[key] += entries
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(dst, dst / "nftbench")
    for c in reg.benchmark["configs"]:
        _shrink(dst / c["file"], "cpu_test")
    for w in reg.benchmark["workloads"]:
        _shrink(dst / "nftbench" / "traffic" / f"{w['traffic']}.json",
                "cpu_test")
        _shrink(dst / "nftbench" / "limits" / f"{w['name']}.json",
                "cpu_test_check", into="check")
    return reg
