"""Forward NFT for the nonlinear Schroedinger equation, vanishing BCs.

Port of ``fnft_tpu/models/nsev.py`` (reference fnft_nsev.c), every
discretization. The pipeline of the fast schemes is the JAX package's:

  preprocess -> fscatter (FFT tree, K1) -> contspec via chirp-Z + phase
  factors -> bound states: subsample fscatter -> Aberth roots of a(z) (K2
  above 4096 roots) -> filter/merge -> vectorized Newton (full D)
  -> norming constants / residues via phi/psi sweeps
  -> optional Richardson extrapolation against a half-D pass.

The slow schemes (BO, CF*, ES4, TES4) evaluate the continuous spectrum by
the monodromy matrix at every xi and localize bound states by Newton only.
Everything runs on the device of ``q``: a tensor's own, the CUDA device for
an array unless ``device=`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    is_fast,
    method_order,
    upsampling_factor,
    z_to_lambda,
)
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.poly import _pow2, chirpz
from fnft_tpu_torch.ops.roots import poly_roots
from fnft_tpu_torch.ops.scatter import scatter_bound_states, scatter_matrix
from fnft_tpu_torch.utils import misc


class BoundStateFilter(enum.Enum):      # fnft_nsev.h:51-55
    NONE = "none"
    BASIC = "basic"
    FULL = "full"


class BoundStateLocalization(enum.Enum):  # fnft_nsev.h:91-95
    FAST_EIGENVALUE = "fast_eigenvalue"
    NEWTON = "newton"
    SUBSAMPLE_AND_REFINE = "subsample_and_refine"


class DiscspecType(enum.Enum):          # fnft_nsev.h:108-112
    NORMING_CONSTANTS = "norming_constants"
    RESIDUES = "residues"
    BOTH = "both"


class ContspecType(enum.Enum):          # fnft_nsev.h:130-134
    REFLECTION_COEFFICIENT = "reflection_coefficient"
    AB = "ab"
    BOTH = "both"


@dataclasses.dataclass(frozen=True)
class NsevOpts:
    """Options (defaults mirror fnft_nsev_default_opts, fnft_nsev.c:26-36)."""

    bound_state_filtering: BoundStateFilter = BoundStateFilter.FULL
    bound_state_localization: BoundStateLocalization = (
        BoundStateLocalization.SUBSAMPLE_AND_REFINE)
    niter: int = 10
    dsub: int = 0  # 0 = auto
    discspec_type: DiscspecType = DiscspecType.NORMING_CONSTANTS
    contspec_type: ContspecType = ContspecType.REFLECTION_COEFFICIENT
    normalization_flag: bool = True
    discretization: Discretization = Discretization.SPLIT4B
    richardson_extrapolation: bool = False


@dataclasses.dataclass
class NsevResult:
    """Requested spectra as tensors on the input's device."""

    reflection_coefficient: Optional[torch.Tensor] = None
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    bound_states: Optional[torch.Tensor] = None
    norming_constants: Optional[torch.Tensor] = None
    residues: Optional[torch.Tensor] = None


def nsev_max_k(d: int, opts: NsevOpts | None = None) -> int:
    """Maximum number of detectable bound states (fnft_nsev_max_K, :51-57)."""
    opts = opts or NsevOpts()
    return degree(opts.discretization) * d


def _re_bound(eps_t: float, map_coeff: float) -> float:
    """Resolvable real-part range (fnft_nsev.c:569-578)."""
    return 0.9 * math.pi / abs(map_coeff * eps_t)


def _im_bound(q, t0: float, t1: float) -> float:
    """Parseval-based bound on bound-state imaginary parts (:582-592)."""
    return float(1.5 * 0.25 * misc.l2norm2(q, t0, t1))


def _chirpz_points(eps_t, xi0, xi1, m, disc):
    """(a, w) of the spiral z_k = a w^k that the xi grid maps to."""
    deg1 = 2.0 / nse.xi_map_coeff(disc)  # = degree * upsampling
    eps_xi = (xi1 - xi0) / (m - 1)
    return (complex(np.exp(2j * xi0 * eps_t / deg1)),
            complex(np.exp(2j * eps_xi * eps_t / deg1)))


def _contspec_eval(tm, q_eff, r_eff, eps_t, xi0, xi1, m, disc, tables=None):
    """H11(xi), H21(xi) on the xi grid (fnft_nsev.c:744-835): chirp-Z of
    the transfer polynomials for a fast scheme (``tables``: see
    :func:`chirpz`), the monodromy matrix at every xi for a slow one.
    ``tm [..., 2, 2, deg+1]`` and ``q_eff [..., D_eff]`` may carry leading
    batch axes; returns ``[..., m]``."""
    if degree(disc) > 0:
        a_pt, w_pt = _chirpz_points(eps_t, xi0, xi1, m, disc)
        # rows (1,1) and (2,1) together
        h = chirpz(tm[..., :, 0, :], a_pt, w_pt, m, tables)
        return h[..., 0, :], h[..., 1, :]
    xi = torch.linspace(xi0, xi1, m, dtype=real_dtype_of(q_eff.dtype),
                        device=q_eff.device)
    t = scatter_matrix(q_eff, r_eff, xi.expand(*q_eff.shape[:-1], m), eps_t,
                       disc)
    return t[..., 0, 0], t[..., 1, 0]


def _apply_phase_factors(h11, h21, w, eps_t, t0, t1, d_given, xi0, xi1, m,
                         disc, contspec_type):
    """The contspec representations from ``h11, h21 [..., m]`` and the
    tree's exponents ``w [...]``."""
    rdt = real_dtype_of(h11.dtype)
    xi = torch.linspace(xi0, xi1, m, dtype=rdt, device=h11.device)
    out = {}
    if contspec_type in (ContspecType.REFLECTION_COEFFICIENT, ContspecType.BOTH):
        pf = nse.phase_factor_rho(eps_t, t1, disc)
        out["rho"] = h21 * torch.exp(1j * xi * pf) / h11
    if contspec_type in (ContspecType.AB, ContspecType.BOTH):
        scale = _pow2(w, rdt)[..., None]   # exact 2^w
        pfa = nse.phase_factor_a(eps_t, d_given, t0, t1, disc)
        pfb = nse.phase_factor_b(eps_t, d_given, t0, t1, disc)
        out["a"] = h11 * scale * torch.exp(1j * xi * pfa)
        out["b"] = h21 * scale * torch.exp(1j * xi * pfb)
    return out


def _newton_refine(q_eff, r_eff, lam0, eps_t, t0, t1, disc, niter,
                   bounding_box):
    """Vectorized Newton iteration on a(lam) (fnft_nsev.c:973-1038).

    All states iterate together for ``niter`` steps without a host sync; a
    state freezes once its update is below 100*eps, it hits a(lam)=0, or
    it leaves the bounding box.
    """
    if lam0.numel() == 0:
        return lam0
    eprec = 100.0 * eps_of(lam0.dtype)
    re0, re1, im0, im1 = bounding_box
    lam = lam0
    active = torch.ones(lam.shape, dtype=torch.bool, device=lam.device)
    for _ in range(niter):
        a, ap, _ = scatter_bound_states(q_eff, r_eff, lam, eps_t, t0, t1,
                                        disc, skip_b=True)
        step = a / torch.where(ap == 0, 1.0, ap)
        step = torch.where((a == 0) | (ap == 0), 0.0, step)
        lam_new = torch.where(active, lam - step, lam)
        in_box = ((lam_new.real >= re0) & (lam_new.real <= re1)
                  & (lam_new.imag >= im0) & (lam_new.imag <= im1))
        active = active & (torch.abs(step) > eprec) & in_box
        lam = lam_new
    return lam


def _compute_boundstates(q_eff, r_eff, q_orig, tm11, eps_t, t0, t1, disc,
                         opts, bsloc, initial_states):
    """Bound-state localization + filtering (fnft_nsev.c:595-741)."""
    map_coeff = 2.0 / max(degree(disc), 1)
    if opts.bound_state_filtering is BoundStateFilter.FULL:
        box = (-_re_bound(eps_t, map_coeff), _re_bound(eps_t, map_coeff),
               0.0, _im_bound(q_orig, t0, t1))
    elif opts.bound_state_filtering is BoundStateFilter.BASIC:
        box = (-math.inf, math.inf, 0.0, math.inf)
    else:
        box = (-math.inf, math.inf, -math.inf, math.inf)

    if bsloc is BoundStateLocalization.FAST_EIGENVALUE:
        lam = z_to_lambda(poly_roots(tm11), eps_t, disc)
    elif bsloc is BoundStateLocalization.NEWTON:
        base = nse.newton_base_discretization(disc)
        lam = _newton_refine(q_eff, r_eff, initial_states, eps_t, t0, t1,
                             base, opts.niter, box)
    else:
        raise ValueError(bsloc)

    if opts.bound_state_filtering is not BoundStateFilter.NONE:
        mask = misc.filter_mask(lam, box)
        mask = misc.merge_mask(lam, misc.merge_tol_default(torch.complex128),
                               mask)
        lam = misc.compact_masked(lam, mask)
    return lam


def _compute_normconsts_or_residues(q_eff, r_eff, lam, eps_t, t0, t1, disc):
    """(normconsts, residues) at bound states (fnft_nsev.c:895-970)."""
    base = nse.newton_base_discretization(disc)
    _, ap, b = scatter_bound_states(q_eff, r_eff, lam, eps_t, t0, t1, base,
                                    skip_b=False)
    return b, b / ap


def _nsev_base(q_eff, r_eff, q_orig, t0, t1, m, xi0, xi1, kappa, opts,
               bsloc, initial_states, want_contspec, want_dspec):
    """One full pass at a fixed resolution (fnft_nsev_base, :458-565)."""
    disc = opts.discretization
    d_given = q_eff.shape[-1] // upsampling_factor(disc)
    eps_t = (t1 - t0) / (d_given - 1)
    tm = None
    w = torch.zeros((), dtype=torch.int32, device=q_eff.device)
    if is_fast(disc):
        tm, w = fscatter(q_eff, r_eff, eps_t, disc,
                         normalize=opts.normalization_flag,
                         want=((0, 0), (1, 0)), jsym=kappa)

    result = NsevResult()
    if want_contspec and m > 0:
        h11, h21 = _contspec_eval(tm, q_eff, r_eff, eps_t, xi0, xi1, m, disc)
        cs = _apply_phase_factors(h11, h21, w, eps_t, t0, t1, d_given,
                                  xi0, xi1, m, disc, opts.contspec_type)
        result.reflection_coefficient = cs.get("rho")
        result.a = cs.get("a")
        result.b = cs.get("b")

    if kappa == +1 and want_dspec:
        lam = _compute_boundstates(q_eff, r_eff, q_orig,
                                   None if tm is None else tm[0, 0], eps_t,
                                   t0, t1, disc, opts, bsloc, initial_states)
        result.bound_states = lam
        if lam.numel() > 0:
            norm, res = _compute_normconsts_or_residues(
                q_eff, r_eff, lam, eps_t, t0, t1, disc)
            result.norming_constants = norm
            result.residues = res
    return result


def _richardson(result, q, t0, t1, m, xi0, xi1, kappa, opts, want_dspec):
    """Richardson extrapolation against a half-resolution pass
    (fnft_nsev.c:316-442)."""
    d = q.shape[-1]
    eps_t = (t1 - t0) / (d - 1)
    qs_eff, rs_eff, dsub_act, (i0, i1) = nse.preprocess_signal(
        q, eps_t, kappa, opts.discretization, (d + 1) // 2)
    ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
    eps_t_sub = (ts1 - ts0) / (dsub_act - 1)

    init = result.bound_states if want_dspec else None
    sub = _nsev_base(qs_eff, rs_eff, q, ts0, ts1, m, xi0, xi1, kappa, opts,
                     BoundStateLocalization.NEWTON, init, m > 0,
                     init is not None and init.numel() > 0)

    scl_num = (eps_t_sub / eps_t) ** method_order(opts.discretization)
    scl_den = scl_num - 1.0

    def rich(full, half):
        return (scl_num * full - half) / scl_den

    if m > 0:
        xi = torch.linspace(xi0, xi1, m, dtype=torch.float64, device=q.device)
        ok = torch.abs(xi) < 0.9 * math.pi / (2.0 * eps_t_sub)
        for field in ("reflection_coefficient", "a", "b"):
            full, half = getattr(result, field), getattr(sub, field)
            if full is not None and half is not None:
                setattr(result, field, torch.where(ok, rich(full, half), full))

    full_bs, half_bs = result.bound_states, sub.bound_states
    if want_dspec and full_bs is not None and full_bs.numel() > 0 \
            and half_bs is not None and half_bs.numel() > 0:
        # match each full-resolution state to its nearest half-res partner
        dist = torch.abs(full_bs[:, None] - half_bs[None, :]) / \
            torch.abs(full_bs)[:, None]
        nearest, loc = torch.min(dist, dim=1)
        ok = nearest < eps_t
        result.bound_states = torch.where(ok, rich(full_bs, half_bs[loc]),
                                          full_bs)
        if result.residues is not None and sub.residues is not None:
            # Richardson on a' (= b/res), then recombine (reference :426-434)
            ap_full = result.norming_constants / result.residues
            ap_half = sub.norming_constants[loc] / sub.residues[loc]
            ap = torch.where(ok, rich(ap_full, ap_half), ap_full)
            result.residues = result.norming_constants / ap
    return result


def _array_device(device=None) -> torch.device:
    """Where an input that is not a tensor goes: ``device``, which defaults
    to the CUDA card. Without CUDA that default raises: the work runs on
    the CPU only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fnft_tpu_torch runs on the CUDA device by default and none is "
            "available; pass device='cpu' (or a CPU tensor) to run on the CPU")
    return dev


def _as_signal(q, device=None) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to
    :func:`_array_device`."""
    if isinstance(q, torch.Tensor):
        return q
    return torch.as_tensor(np.asarray(q), device=_array_device(device))


def _nsev(q, t_span, m, xi_span, kappa, opts, want_bound_states,
          initial_states):
    opts = opts or NsevOpts()
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(d >= 2, "D must be >= 2")
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    if m > 0:
        check_arg(xi_span is not None and float(xi_span[0]) < float(xi_span[1]),
                  "valid XI required for continuous spectrum")
    xi0, xi1 = (float(xi_span[0]), float(xi_span[1])) if xi_span else (0.0, 0.0)
    disc = opts.discretization
    if not is_fast(disc) and kappa == +1 and want_bound_states:
        check_arg(opts.bound_state_localization is BoundStateLocalization.NEWTON,
                  "slow discretizations support only NEWTON localization")

    eps_t = (t1 - t0) / (d - 1)
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)
    want_dspec = want_bound_states and kappa == +1
    bsloc = opts.bound_state_localization

    if (want_dspec and bsloc is BoundStateLocalization.SUBSAMPLE_AND_REFINE
            and is_fast(disc)):
        # two-pass method: subsampled fast eigenvalues, full-D Newton
        dsub = opts.dsub or int(math.sqrt(d * math.log2(d) ** 2))
        qs_eff, rs_eff, _, (i0, i1) = nse.preprocess_signal(
            q, eps_t, kappa, disc, dsub)
        ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
        sub = _nsev_base(qs_eff, rs_eff, q, ts0, ts1, 0, xi0, xi1, kappa,
                         opts, BoundStateLocalization.FAST_EIGENVALUE, None,
                         False, True)
        result = _nsev_base(q_eff, r_eff, q, t0, t1, m, xi0, xi1, kappa,
                            opts, BoundStateLocalization.NEWTON,
                            sub.bound_states, m > 0, True)
    else:
        if bsloc is BoundStateLocalization.NEWTON and initial_states is None:
            raise ValueError(
                "NEWTON localization needs initial bound states; use "
                "nsev_with_initial_states or SUBSAMPLE_AND_REFINE")
        result = _nsev_base(q_eff, r_eff, q, t0, t1, m, xi0, xi1, kappa, opts,
                            bsloc, initial_states, m > 0, want_dspec)
    if opts.richardson_extrapolation:
        result = _richardson(result, q, t0, t1, m, xi0, xi1, kappa, opts,
                             want_dspec)
    return result


def nsev(q, t_span, *, m: int = 0, xi_span=None, kappa: int = +1,
         opts: NsevOpts | None = None,
         want_bound_states: bool = True, device=None) -> NsevResult:
    """Fast forward NFT of the vanishing-BC NSE (reference fnft_nsev.c:133).

    Args:
      q: complex signal samples ``[D]`` on the grid t_n = T0 + n eps_t; a
        tensor (the work runs on its device, in its precision) or an array.
      t_span: (T0, T1).
      m: number of continuous-spectrum points (0 = skip contspec).
      xi_span: (XI0, XI1) spectral grid bounds (required when m > 0).
      kappa: +1 focusing, -1 defocusing.
      opts: :class:`NsevOpts`.
      want_bound_states: compute the discrete spectrum (kappa=+1 only).
      device: where an array ``q`` goes (default: the CUDA device; raises
        without one). A tensor ``q`` stays on its own device.

    Returns :class:`NsevResult` with requested fields populated.
    """
    return _nsev(_as_signal(q, device), t_span, m, xi_span, kappa, opts,
                 want_bound_states, None)


def nsev_with_initial_states(q, t_span, initial_states, *, m: int = 0,
                             xi_span=None, kappa: int = +1,
                             opts: NsevOpts | None = None,
                             device=None) -> NsevResult:
    """NEWTON-localized nsev with user-supplied initial bound states, which
    follow ``q``'s device (``device`` as in :func:`nsev`)."""
    opts = dataclasses.replace(
        opts or NsevOpts(),
        bound_state_localization=BoundStateLocalization.NEWTON)
    q = _as_signal(q, device)
    lam0 = torch.as_tensor(np.asarray(initial_states), device=q.device).to(
        complex_dtype_of(q))
    return _nsev(q, t_span, m, xi_span, kappa, opts, True, lam0)
