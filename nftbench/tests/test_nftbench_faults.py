"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (``run_cell`` on the CPU,
at the sizes the files name under ``cpu_test``) and drives the rest of a
run, with the limits the cells hold on the card: once unbroken, once for
each fault a batched transform can have (half of the batch left out, one
answer altered where it is produced) and once with the control, the
reference in complex64, in the program's place.
"""

import dataclasses
import time

import pytest
import torch

from nftbench.tests.tinytree import tiny_tree
from nftbench.harness.runner import run_cell

WORKLOADS = ["nfdm_4096.rx_b1024", "nsev_65536.full_b128"]


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def _fields(out):
    """(getter, setter) over the output's batch-first tensors."""
    if isinstance(out, dict):
        return list(out.items()), lambda kv: dict(kv)
    items = [(f.name, getattr(out, f.name)) for f in dataclasses.fields(out)]
    return items, lambda kv: dataclasses.replace(out, **dict(kv))


def half_batch(fn):
    """The second half of the rows is the first half's."""
    def run(batch):
        items, make = _fields(fn(batch))
        return make([(k, torch.cat([v[:v.shape[0] // 2]] * 2))
                     for k, v in items])
    return run


def one_answer_altered(fn):
    """One row's answer moved by one part in a million where it is made."""
    def run(batch):
        out = fn(batch)
        items, make = _fields(out)
        name = "rho" if isinstance(out, dict) else "bound_states"
        return make([(k, torch.where(
            torch.arange(v.shape[0])[:, None] == v.shape[0] // 3,
            v * (1 + 1e-6), v) if k == name else v) for k, v in items])
    return run


def _run(reg, workload, fault=None, trace=False):
    return run_cell(workload, 2**31 + 4321, 0.2, trace, time.perf_counter(),
                    registry=reg, device="cpu", fault=fault)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_run_is_correct(reg, workload, trace):
    res = _run(reg, workload, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [half_batch, one_answer_altered])
def test_fault_is_not_correct(reg, workload, fault):
    res = _run(reg, workload, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(reg, workload, monkeypatch):
    """The run judges the complex64 reference's values where the program's
    would be: some number compared exceeds its limit."""
    import nftbench.harness.runner as runner

    real_judge = runner.judge

    def judge(ref, cfg, limits, pool, kept, seed, batch):
        return real_judge(ref, cfg, limits, pool, {p: pool[p] for p in kept},
                          seed, batch, lambda c, item, pl: ref.expected(
                              c, item, pl, torch.complex64))

    monkeypatch.setattr(runner, "judge", judge)
    res = _run(reg, workload)
    assert not res["correct"], res["checks"]
