"""No run loads jax, jaxlib, flax or the JAX package fnft_tpu; the check
compares top-level module names whole, and nothing under nftbench/ reads
the JAX package's tools or records."""

import ast
import re
import sys
import types

from nftbench.harness.registry import BENCH_DIR
from nftbench.harness.runner import forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "fnft_tpu"}


def test_check_compares_whole_top_level_names(monkeypatch):
    base = set(forbidden_modules())
    for name in ("fnft_tpu_torch_x", "fnft_tpux", "jaxx", "my.jax",
                 "flaxen.fnft_tpu"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(forbidden_modules()) == base
    for name in ("fnft_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(forbidden_modules()) == base | FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_read_no_jax_records():
    records = re.compile(r"bench\.py|BENCH_r|BASELINE\.md|TPU_MEASUREMENTS|"
                         r"MULTICHIP_r|docs/performance|docs/roofline|"
                         r"bench_drivers|slow_gate|tpu_watch")
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.relative_to(BENCH_DIR).parts:
            continue
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
        assert not records.search(path.read_text()), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "math", "torch",
                                         "numpy", "nftbench"), (path, mod)
            assert not mod.startswith(("nftbench.entries",
                                       "nftbench.harness")), (path, mod)
