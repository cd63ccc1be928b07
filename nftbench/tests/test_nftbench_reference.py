"""The plain reference agrees with fnft_tpu_torch at tiny sizes on the CPU,
and the traffic generator is a function of the seed."""

import math

import pytest
import torch

from nftbench.harness.generate import generate
from nftbench.reference import akns
from nftbench.tests.tinytree import tiny_tree


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


def _cell(reg, workload):
    cell = reg.cell(workload)
    cfg = reg.config(cell["config"])
    return cfg, reg.traffic(cell["traffic"]), reg.limits(workload)


@pytest.mark.parametrize("workload", ["nfdm_4096.rx_b1024",
                                      "nsev_65536.full_b128"])
def test_reference_agrees_with_the_port(reg, workload):
    """Every number compared is near rounding for the port's own output,
    and the reference in complex64 reads far above it."""
    cfg, traffic, limits = _cell(reg, workload)
    entry, ref = reg.entry(cfg["entry"]), reg.reference(cfg["entry"])
    pool = generate(reg, traffic, cfg, 2**31 + 99, "cpu")
    out = entry.build(cfg, "cpu")(pool[0])
    pl = ref.plan(cfg, traffic["batch"], limits["check"], 1)
    exp = ref.expected(cfg, pool[0], pl)
    got = ref.compare(exp, ref.observed(cfg, out, pl))
    low = ref.compare(exp, ref.expected(cfg, pool[0], pl, torch.complex64))
    for k, v in got.items():
        if k == "count_miss":
            assert v == 0 and low[k] == 0
        else:
            assert v < 1e-11, (k, v)
            assert low[k] > 1e-8, (k, low[k])


def test_bo_norming_constant_is_the_ports():
    """b at bound states (BO), against the port's phi/psi sweeps."""
    from fnft_tpu_torch.models.discretization import Discretization
    from fnft_tpu_torch.ops.scatter import scatter_bound_states

    d, t0, t1 = 1024, -25.0, 25.0
    h = (t1 - t0) / (d - 1)
    t = torch.linspace(t0, t1, d, dtype=torch.float64)
    amp = torch.tensor([[2.2], [1.3]], dtype=torch.float64)
    q = (amp / torch.cosh(t)).to(torch.complex128) * torch.exp(
        1j * torch.tensor([[0.3], [1.1]], dtype=torch.float64))
    lam0 = 1j * torch.tensor([[1.7, 0.7], [0.8, 0.8]], dtype=torch.float64)
    lam = akns.bo_newton(q, lam0.to(torch.complex128), h, t0 - h / 2,
                         t1 + h / 2)
    a = akns.bo_a(q, lam, h, t0 - h / 2, t1 + h / 2)
    assert float(a.abs().max()) < 1e-12
    _, _, b = scatter_bound_states(q, -torch.conj(q), lam, h, t0, t1,
                                   Discretization.BO)
    ref = akns.bo_b(q, lam, h, t0 - h / 2, t1 + h / 2)
    assert float((b - ref).abs().max()) < 1e-11


def test_born_bursts_carry_their_symbols(reg):
    """The bursts' spectrum is the transmitted one to first order: at the
    carrier centres rho is within a tenth of rho_tx."""
    cfg, traffic, limits = _cell(reg, "nfdm_4096.rx_b1024")
    traffic = dict(traffic, carriers=2, centers=[-3.0, 3.0], amplitude=0.05)
    item = generate(reg, traffic, cfg, 11, "cpu")[0]
    xi = torch.linspace(*cfg["xi_span"], cfg["M"], dtype=torch.float64)
    a, b = reg.reference(cfg["entry"]).contspec(cfg, item["q"], xi)
    rho = b / a
    for c in (-3.0, 3.0):
        k = int(torch.argmin((xi - c).abs()))
        pulse = math.exp(-((float(xi[k]) - c) / traffic["width"]) ** 2)
        assert abs(float(rho[:, k].abs().max()) / (0.05 * pulse) - 1) < 0.1


@pytest.mark.parametrize("workload", ["nfdm_4096.rx_b1024",
                                      "nsev_65536.full_b128"])
def test_inputs_follow_the_seed(reg, workload):
    cfg, traffic, _ = _cell(reg, workload)
    one = generate(reg, traffic, cfg, 2**33 + 5, "cpu")
    two = generate(reg, traffic, cfg, 2**33 + 5, "cpu")
    other = generate(reg, traffic, cfg, 2**33 + 6, "cpu")
    assert all(torch.equal(x["q"], y["q"]) for x, y in zip(one, two))
    assert not torch.equal(one[0]["q"], other[0]["q"])
    assert one[0]["q"].shape == (traffic["batch"], cfg["D"])
    if "count" in one[0]["hints"]:   # the same classes on every seed
        assert torch.equal(one[0]["hints"]["count"].sort()[0],
                           other[0]["hints"]["count"].sort()[0])
