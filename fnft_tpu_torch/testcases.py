"""Analytic NFT test cases with exact spectra (numpy-only).

A copy of ``fnft_tpu/testcases.py``; ``nsev_errors`` also takes the torch
tensors the port returns, on any device. The KdV cases at the end are the
ones the reference's kdvv tests build.

Port of the reference's testcase generators that are compiled into the
library itself (src/private/fnft__nsev_testcases.c:32-822,
fnft__kdvv_testcases.c, fnft__nsep_testcases.c). The 40-digit constants
below are mathematical data (symbolically computed exact spectra of closed-
form potentials), quoted from the reference where they are derived via
MATLAB symbolic toolbox; original sources are cited per case.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np



class NsevTestcase(enum.Enum):
    SECH_FOCUSING = "sech_focusing"         # Satsuma & Yajima 1974, A=3.2
    SECH_FOCUSING2 = "sech_focusing2"       # Chimmalgi/Prins/Wahls 2019, A=5.4
    SECH_DEFOCUSING = "sech_defocusing"     # Frumin et al., JOSA B 32(2) 2015
    TRUNCATED_SOLITON = "truncated_soliton"  # Lamb 1980, ch. 3.8


@dataclasses.dataclass
class NsevTestData:
    q: np.ndarray
    t_span: tuple
    xi_span: tuple
    m: int
    kappa: int
    contspec: np.ndarray          # reflection coefficient on the xi grid
    a: np.ndarray | None
    b: np.ndarray | None
    bound_states: np.ndarray
    normconsts: np.ndarray
    residues: np.ndarray


def _sech(x):
    return 1.0 / np.cosh(x)


# exact rho/a/b for SECH_FOCUSING (Satsuma-Yajima A=3.2) on
# xi = (-7:8)/5; constants from fnft__nsev_testcases.c:142-260.
_SY_CONTSPEC = np.array([
    0.01418788668709013595992021025473684215882 - 0.002780494135403430187512334448840356894033j,
    0.02241182921176242546967787829962193792932 - 0.01523064097337719809817988712025498134135j,
    0.02465858976907935401910832019686315816969 - 0.04438144029159159323809699075974745310038j,
    -0.003769955008351912170484991343204667254443 - 0.09495492126539469847498823350667910603724j,
    -0.1125183095807641031140695325799053429154 - 0.1368780622436166383108546963189442789103j,
    -0.3233468273512117378446470596682895379774 - 0.03729229993634457693343890962907380139133j,
    -0.4116152074717953525393539594551519006178 + 0.3788164254609808107108977070302734836415j,
    0.7265425280053608858954667574806187496161j,
    0.4116152074717953525393539594551519006178 + 0.3788164254609808107108977070302734836415j,
    0.3233468273512117378446470596682895379774 - 0.03729229993634457693343890962907380139133j,
    0.1125183095807641031140695325799053429154 - 0.1368780622436166383108546963189442789103j,
    0.003769955008351912170484991343204667254443 - 0.09495492126539469847498823350667910603724j,
    -0.02465858976907935401910832019686315816969 - 0.04438144029159159323809699075974745310038j,
    -0.02241182921176242546967787829962193792932 - 0.01523064097337719809817988712025498134135j,
    -0.01418788668709013595992021025473684215882 - 0.002780494135403430187512334448840356894033j,
    -0.007616495541673034905010512686300960103961 + 0.001218250087174144753540506062403435472519j,
])

_SY_A = np.array([
    0.1922981551089552207414790788104399336051 - 0.9812300627012406776576449201797836254391j,
    0.561866472778759866094679757854572199885 - 0.8267843388695356739056977390134312187561j,
    0.8730141099108177240539975329792577203606 - 0.4850517842024005091448564057792135627085j,
    0.99473134297967765839265519878851030091 + 0.03949339706100667801810586124473818981564j,
    0.7606487443184108526272926017586175655859 + 0.6252785106141419778427378472314923857149j,
    0.1089468485775085556086575508888526656452 + 0.9446351632262268082615533423570763855373j,
    -0.590997041209672540861257403754476421502 + 0.6421669003309714788364298184082912989208j,
    -0.8090169943749474241022934171828190588602 + 0j,
    -0.590997041209672540861257403754476421502 - 0.6421669003309714788364298184082912989208j,
    0.1089468485775085556086575508888526656452 - 0.9446351632262268082615533423570763855373j,
    0.7606487443184108526272926017586175655859 - 0.6252785106141419778427378472314923857149j,
    0.99473134297967765839265519878851030091 - 0.03949339706100667801810586124473818981564j,
    0.8730141099108177240539975329792577203606 + 0.4850517842024005091448564057792135627085j,
    0.561866472778759866094679757854572199885 + 0.8267843388695356739056977390134312187561j,
    0.1922981551089552207414790788104399336051 + 0.9812300627012406776576449201797836254391j,
    -0.1579366040628854761179976110287556423348 + 0.9874191295994487368292392806331584236124j,
])

_SY_B = -1j * np.array([
    0.01445626483610090114054909784096292396108,
    0.02708733591957504791796401942967379252746,
    0.05070631655613093722786537802129497025788,
    0.09460352468290259430624658322771974638099,
    0.1744714072018253986997192102912036857244,
    0.3095076615878664435099104772640477540624,
    0.4882050485203166754374126644029116788666,
    0.5877852522924731291687059546390727685977,
    0.4882050485203166754374126644029116788666,
    0.3095076615878664435099104772640477540624,
    0.1744714072018253986997192102912036857244,
    0.09460352468290259430624658322771974638099,
    0.05070631655613093722786537802129497025788,
    0.02708733591957504791796401942967379252746,
    0.01445626483610090114054909784096292396108,
    0.007713079680024468575954854247144612396039,
])

_SF2_CONTSPEC = np.array([
    -0.01289273278003152905918121745470847365421 + 0.01952442321687538178496497287804460875026j,
    0.0004110228185622213651773947863625359381154 + 0.04386846056673063214252166530876724394744j,
    0.05118857841273878041981365229970875892711 + 0.06447211910210706876557338064393669393516j,
    0.1530999061308424125667759423303266818395 + 0.02352767805803699061473265385901026801587j,
    0.2243341367932093727319711402903268069812 - 0.1904439868202336158475261772625496323302j,
    -0.07062432466685394387275577841546898300341 - 0.5742469532143871825737737078429363399421j,
    -1.197848513274026122135421633616793204941 - 0.4740093463798981210732486518885878849946j,
    -3.077683537175253402570290576036909824007 + 0j,
    -1.197848513274026122135421633616793204941 + 0.4740093463798981210732486518885878849946j,
    -0.07062432466685394387275577841546898300341 + 0.5742469532143871825737737078429363399421j,
    0.2243341367932093727319711402903268069812 + 0.1904439868202336158475261772625496323302j,
    0.1530999061308424125667759423303266818395 - 0.02352767805803699061473265385901026801587j,
    0.05118857841273878041981365229970875892711 - 0.06447211910210706876557338064393669393516j,
    0.0004110228185622213651773947863625359381154 - 0.04386846056673063214252166530876724394744j,
    -0.01289273278003152905918121745470847365421 - 0.01952442321687538178496497287804460875026j,
    -0.01123305135343309779512753035134571731394 - 0.005440022560146829665059720756218907459592j,
])

_SF2_A = np.array([
    -0.5508883224398498741455357032117565153713 - 0.8342511192979083133082038560515639998599j,
    0.009360023835442056142111077473968563647467 - 0.9989952333183900837231024006403602522748j,
    0.6197122943039986949196235349415904634129 - 0.7805289009054497517383544640087683571515j,
    0.9767488815483188814742711524607628343479 - 0.1501022032565899769418304628745613460413j,
    0.7313341805241946746381271107447142311081 + 0.6208515521885211989814075613931362418614j,
    -0.1056564935663928164873655649798580333476 + 0.8590938009534291149158524894935438454092j,
    -0.5701744656703106249760555258514335084085 + 0.2256278843275265350402069559530437209489j,
    -0.3090169943749474241022934171828190588602 + 0j,
    -0.5701744656703106249760555258514335084085 - 0.2256278843275265350402069559530437209489j,
    -0.1056564935663928164873655649798580333476 - 0.8590938009534291149158524894935438454092j,
    0.7313341805241946746381271107447142311081 - 0.6208515521885211989814075613931362418614j,
    0.9767488815483188814742711524607628343479 + 0.1501022032565899769418304628745613460413j,
    0.6197122943039986949196235349415904634129 + 0.7805289009054497517383544640087683571515j,
    0.009360023835442056142111077473968563647467 + 0.9989952333183900837231024006403602522748j,
    -0.5508883224398498741455357032117565153713 + 0.8342511192979083133082038560515639998599j,
    -0.8999422454658634837367075136498547418378 + 0.435830475987919759106168274101929247041j,
])

_SF2_B = np.array([
    0.0233907278551811859677095969224396957117,
    0.04382823018255831570567080228852341708061,
    0.08204454363213137176985421975407187254546,
    0.1530717183924760158625863771621162907575,
    0.2823006669175766801574502038748919300431,
    0.5007939162276681549083069050468682276651,
    0.7899323619851639401337542814226470743617,
    0.9510565162951535721164393333793821434057,
    0.7899323619851639401337542814226470743617,
    0.5007939162276681549083069050468682276651,
    0.2823006669175766801574502038748919300431,
    0.1530717183924760158625863771621162907575,
    0.08204454363213137176985421975407187254546,
    0.04382823018255831570567080228852341708061,
    0.0233907278551811859677095969224396957117,
    0.01248002508021575354337474577945871169292,
], dtype=complex)

_FRUMIN_CONTSPEC = np.array([
    0.000354402005409124 - 0.000856556445220169j,
    0.0031344195756859 - 0.00277695685654264j,
    0.0186103836129823 - 0.00337452951491781j,
    0.0738785929426912 + 0.0422315609342956j,
    0.012178300033312 + 0.355929084917868j,
    -0.799057399806481 + 0.162320304355872j,
    -0.671009393065244 - 0.62372535759237j,
    -0.352921514622915 - 0.851859435414979j,
    -0.284081974418297 - 0.877527732785861j,
    -0.484126535045771 - 0.785068698342982j,
    -0.851098322732806 - 0.353358655774295j,
    -0.581645322924268 + 0.694092574725766j,
    0.559070643445252 + 0.411896895607473j,
    0.225438957649198 - 0.0208542781733656j,
    0.0420552444423587 - 0.0299273399538242j,
    0.0054223424902175 - 0.010076662096351j,
])


def nsev_testcase(tc: NsevTestcase, d: int) -> NsevTestData:
    """Signal + exact spectrum for a test case at D samples."""
    g = math.gamma
    if tc is NsevTestcase.SECH_FOCUSING:
        t_span = (-25.0, 25.0)
        t = np.linspace(t_span[0], t_span[1], d)
        q = 1j * 3.2 * _sech(t)
        xi_span = (-7.0 / 5.0, 8.0 / 5.0)
        bs = 1j * np.array([0.7, 1.7, 2.7])
        norm = np.array([1j, -1j, 1j])
        res = np.array([
            -1428.0 * g(2 / 5) / (25.0 * g(1 / 5) ** 2),
            -5236.0 * g(2 / 5) / (15.0 * g(1 / 5) ** 2),
            -4284.0 * g(2 / 5) / (11.0 * g(1 / 5) ** 2),
        ], dtype=complex)
        return NsevTestData(q, t_span, xi_span, 16, +1, _SY_CONTSPEC,
                            _SY_A, _SY_B, bs, norm, res)
    if tc is NsevTestcase.SECH_FOCUSING2:
        t_span = (-32.0, 34.0)
        t = np.linspace(t_span[0], t_span[1], d)
        q = 5.4 * _sech(t) * np.exp(-6j * t)
        xi_span = (8.0 / 5.0, 23.0 / 5.0)
        bs = 3.0 + 1j * np.array([0.9, 1.9, 2.9, 3.9, 4.9])
        norm = np.array([-1.0, 1.0, -1.0, 1.0, -1.0], dtype=complex)
        res = -1j * g(4 / 5) / g(2 / 5) ** 2 * np.array([
            69426.0 / 625.0, 1348848.0 / 875.0, 1095939.0 / 175.0,
            5673096.0 / 595.0, 902538.0 / 187.0])
        return NsevTestData(q, t_span, xi_span, 16, +1, _SF2_CONTSPEC,
                            _SF2_A, _SF2_B, bs, norm, res)
    if tc is NsevTestcase.SECH_DEFOCUSING:
        t_span = (-2.0, 1.5)
        t = np.linspace(t_span[0], t_span[1], d)
        qq, gam, f = 1.0, 1.0 / 25.0, 1.5
        q = -np.conj(qq / gam * _sech(t / gam) ** (1 - 2j * f))
        xi_span = (-100.0, 80.0)
        empty = np.zeros(0, dtype=complex)
        return NsevTestData(q, t_span, xi_span, 16, -1, _FRUMIN_CONTSPEC,
                            None, None, empty, empty, empty)
    if tc is NsevTestcase.TRUNCATED_SOLITON:
        t_span = (0.0, 15.0)
        t = np.linspace(t_span[0], t_span[1], d)
        be = 0.55
        q = -2.0 * be * _sech(2.0 * be * t)
        q[0] *= 0.5  # discontinuity at t=0
        xi_span = (0.5, 3.0)
        m = 16
        xi = np.linspace(xi_span[0], xi_span[1], m)
        contspec = -1j * be / xi * (xi + 1j * be) / (xi - 1j * be)
        empty = np.zeros(0, dtype=complex)
        return NsevTestData(q, t_span, xi_span, m, +1, contspec,
                            None, None, empty, empty, empty)
    raise ValueError(tc)


def _host(x) -> np.ndarray:
    """numpy copy of a torch tensor (any device) or array-like."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def nsev_errors(result, data: NsevTestData) -> dict:
    """The reference's six relative errors (fnft__nsev_testcases.c:711-806).

    Keys: contspec, a, b, bound_states (Hausdorff), normconsts, residues.
    Missing quantities map to None.
    """
    # pure-numpy metrics on the host
    def _rel(numer, exact):
        numer = _host(numer).ravel()
        exact = np.asarray(exact).ravel()
        return float(np.sum(np.abs(numer - exact)) / np.sum(np.abs(exact)))

    def _hausdorff(a, b):
        d = np.abs(_host(a).ravel()[:, None]
                   - np.asarray(b).ravel()[None, :])
        return float(max(d.min(axis=1).max(), d.min(axis=0).max()))

    errs = {"contspec": None, "a": None, "b": None,
            "bound_states": None, "normconsts": None, "residues": None}
    if result.reflection_coefficient is not None:
        errs["contspec"] = _rel(result.reflection_coefficient, data.contspec)
    if result.a is not None and data.a is not None:
        errs["a"] = _rel(result.a, data.a)
    if result.b is not None and data.b is not None:
        errs["b"] = _rel(result.b, data.b)
    if data.bound_states.size > 0 and result.bound_states is not None:
        got_bs = _host(result.bound_states)
        errs["bound_states"] = (_hausdorff(got_bs, data.bound_states)
                                if got_bs.size else np.inf)
        if got_bs.size and result.norming_constants is not None:
            # match each exact state with the nearest computed one (:668-705)
            idx = np.argmin(np.abs(got_bs[None, :] - data.bound_states[:, None]),
                            axis=1)
            errs["normconsts"] = _rel(
                _host(result.norming_constants)[idx], data.normconsts)
            if result.residues is not None:
                errs["residues"] = _rel(
                    _host(result.residues)[idx], data.residues)
    return errs


# ---------------------------------------------------------------------------
# KdV cases (reference src/private/fnft__kdvv_testcases.c), exact spectra
# from their closed forms
# ---------------------------------------------------------------------------

def kdvv_sech_case(d: int, m: int = 16):
    """Squared-sech potential 3.2 sech^2(t) (Trogdon et al. 2012 / Drazin &
    Johnson) on D samples: (u, t_span, xi_span, exact rho on the m-point
    xi grid; the reference's tests take m = 16)."""
    import scipy.special as sp

    a_amp = 3.2
    t_span = (-16.0, 15.0)
    u = a_amp / np.cosh(np.linspace(*t_span, d)) ** 2
    xi_span = (-71.0 / 20.0, 79.0 / 20.0)
    xi = np.linspace(*xi_span, m)
    s = np.sqrt(a_amp + 0.25)
    at = 0.5 - 1j * xi + s
    bt = 0.5 - 1j * xi - s
    ct = 1.0 - 1j * xi
    a_of = sp.gamma(at) * sp.gamma(bt) / (sp.gamma(ct) * sp.gamma(at + bt - ct))
    rho = a_of * sp.gamma(ct) * sp.gamma(ct - at - bt) / (
        sp.gamma(ct - at) * sp.gamma(ct - bt))
    return u, t_span, xi_span, rho


def kdvv_rect_case(d: int, ampl: float):
    """Osborne's rectangular well/barrier of height ``ampl`` on |t| < 1/2:
    (u, t_span, xi_span, exact rho at m = 16)."""
    t_span = (-1.0, 2.0)
    t = np.linspace(*t_span, d)
    u = np.where(np.abs(t) < 0.5, float(ampl), 0.0)
    u = np.where(np.abs(t) == 0.5, ampl / 2.0, u)
    zeta = np.arange(16) * np.pi / 32.0
    xi_span = (0.0, 15.0 / 32.0 * np.pi)
    ell = 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        kap = np.sqrt(ampl + zeta.astype(complex) ** 2)
        gam = (kap / zeta - zeta / kap) / 2.0
        dlt = (kap / zeta + zeta / kap) / 2.0
        tr = np.exp(-2j * zeta * ell) / (np.cos(2 * kap * ell)
                                         - 1j * dlt * np.sin(2 * kap * ell))
        rho = 1j * gam * np.sin(2 * kap * ell) * tr
    rho[0] = -1.0  # limit value at zeta = 0
    return u, t_span, xi_span, rho


def kdvv_poschl_teller_case(d: int, s: float):
    """Poeschl-Teller potential s(s+1) sech^2(t) on (-20, 20): (u, t_span,
    exact kappa_n = s - n of the bound states zeta_n = i kappa_n)."""
    t_span = (-20.0, 20.0)
    u = s * (s + 1) / np.cosh(np.linspace(*t_span, d)) ** 2
    return u, t_span, np.array([s - n for n in range(int(np.ceil(s)))])
