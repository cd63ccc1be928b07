"""The batched nsep of the PyTorch port (``fnft_tpu_torch.parallel.
batch_nsep``) against the JAX package's batched nsep and the port's
per-signal nsep (SUBSAMPLE_AND_REFINE), signal by signal. Same numpy
inputs to both (complex128, CPU); the JAX oracle runs once, in a
module-scoped fixture.

Tolerances:
- against the port's per-signal nsep, as ``tests/test_batch_nsep.py:28-34``
  holds the JAX package's batched nsep to its own driver: the compacted
  spectra hold as many points as the driver's, and each of the driver's
  points lies within 1e-8 of one of them;
- against the JAX package's batched nsep: masks equal; each row's points,
  as sets (the two roots of a double point may come out in either order),
  within 5e-4 (main) and 1e-7 (aux) of the JAX package's. The plane waves'
  real main points are double points (closed gaps), where Newton
  converges linearly and stops once |Delta -+ 2| < sqrt(eps), ~1e-4 from
  the exact point at this D, and an unconverged point ends at its
  least-residual iterate in the port and at its last one in the JAX
  package: the per-signal drivers of the two packages differ as much
  (``tests/test_torch_nsep.py``, 5e-4 for subsample-and-refine). The aux
  spectrum of the amplitude-1 wave has a double point at 0, where the two
  packages' iterates stop 8e-8 apart; its simple points agree to ~1e-14.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fnft_tpu.parallel import batch_nsep as jbn
import fnft_tpu_torch as tft
from fnft_tpu_torch.models import nsep as tnsep
from fnft_tpu_torch.parallel import batch_nsep as tbn

torch.set_num_threads(1)

D, T_SPAN, AMPS = 256, (0.0, 2 * np.pi), (1.0, 0.8, 1.2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _near(got, want) -> float:
    """Largest distance of a point of ``want`` to its nearest in ``got``."""
    got, want = _np(got), _np(want)
    return float(np.max(np.min(np.abs(got[:, None] - want[None, :]), axis=0)))


@pytest.fixture(scope="module")
def batch():
    qb = np.stack([np.full(D, a, complex) for a in AMPS])
    ref = jbn.batched_nsep(jnp.asarray(qb), T_SPAN, kappa=+1)
    ref = {k: _np(getattr(ref, k)) for k in (
        "main_spectrum", "main_mask", "aux_spectrum", "aux_mask")}
    got = tbn.batched_nsep(torch.as_tensor(qb), T_SPAN, kappa=+1)
    return qb, ref, got


def test_batched_nsep_matches_jax(batch):
    _, ref, got = batch
    assert isinstance(got, tbn.BatchedNsepResult)
    for key, tol in (("main", 5e-4), ("aux", 1e-7)):
        mask = _np(getattr(got, f"{key}_mask"))
        assert np.array_equal(mask, ref[f"{key}_mask"]), key
        pts = _np(getattr(got, f"{key}_spectrum"))
        assert pts.shape == ref[f"{key}_spectrum"].shape
        for row in range(len(AMPS)):
            mine, theirs = pts[row][mask[row]], ref[f"{key}_spectrum"][row][
                mask[row]]
            assert max(_near(mine, theirs), _near(theirs, mine)) < tol, key


@pytest.mark.parametrize("row", range(len(AMPS)))
def test_batched_nsep_row_matches_driver(batch, row):
    qb, _, got = batch
    ref = tft.nsep(torch.as_tensor(qb[row]), T_SPAN, kappa=+1,
                   opts=tft.NsepOpts(
                       localization=tft.Localization.SUBSAMPLE_AND_REFINE))
    for key, want in (("main", ref.main_spectrum), ("aux", ref.aux_spectrum)):
        pts = getattr(got, f"{key}_spectrum")[row][
            getattr(got, f"{key}_mask")[row]]
        assert pts.numel() == want.numel() > 0, key
        assert _near(pts, want) < 1e-8, key


def test_batched_nsep_quasi_periodic_shift():
    """phase_shifts shift each signal's spectra as the per-signal
    phase_shift does: exp(0.5 i t) with phase shift pi has the spectra of
    the constant 1 shifted by -0.25, held to the per-signal driver's and
    to the unshifted signal's minus 0.25. The phase is removed in another
    shape than the driver's, so the inputs differ by rounding (~1e-16);
    at double points the iterates of two such runs stop apart: up to 3e-4
    on the main spectrum (held to the 5e-4 that ``tests/test_torch_nsep.py``
    allows subsample-and-refine's main spectra for that reason), 7e-8 at
    the aux spectrum's double point at 0 (held to 1e-7, as against the
    JAX package above)."""
    t = 2 * np.pi / D * np.arange(D)
    qb = np.stack([np.exp(0.5j * t), np.ones(D, complex)])
    shifts = [np.pi, 0.0]
    got = tbn.batched_nsep(torch.as_tensor(qb), T_SPAN, phase_shifts=shifts)
    spectra = {}
    for row in range(2):
        ref = tft.nsep(torch.as_tensor(qb[row]), T_SPAN,
                       phase_shift=shifts[row], opts=tft.NsepOpts(
                           localization=tft.Localization.SUBSAMPLE_AND_REFINE))
        for key, want, tol in (("main", ref.main_spectrum, 5e-4),
                               ("aux", ref.aux_spectrum, 1e-7)):
            pts = getattr(got, f"{key}_spectrum")[row][
                getattr(got, f"{key}_mask")[row]]
            assert pts.numel() == want.numel() > 0, key
            assert _near(pts, want) < tol, key
            spectra[key, row] = pts
    for key, tol in (("main", 5e-4), ("aux", 1e-7)):
        assert spectra[key, 0].numel() == spectra[key, 1].numel()
        assert _near(spectra[key, 0], spectra[key, 1] - 0.25) < tol, key


def test_batched_sweeps_leave_frozen_points_out(monkeypatch):
    """Points masked out of the box are never evaluated, and the batch's
    evaluations shrink as points freeze."""
    sizes = []
    orig = tnsep._monodromy

    def counting(q_eff, r_eff, lam, *a):
        sizes.append(lam.shape[0])
        return orig(q_eff, r_eff, lam, *a)

    monkeypatch.setattr(tnsep, "_monodromy", counting)
    qb = np.stack([np.full(D, a, complex) for a in AMPS[:2]])
    fn = tbn.make_batched_nsep_fn(D, T_SPAN, device="cpu")
    main, mmask, aux, amask = fn(torch.as_tensor(qb), [0.0, 0.0])
    n_main, n_aux = int(mmask.sum()), int(amask.sum())
    assert sizes[0] <= main.numel() and sizes[0] >= n_main
    assert sizes[1] <= 2 * sizes[0] and sizes[-1] < sizes[1]
    assert n_aux > 0
