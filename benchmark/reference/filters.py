"""The windowed-jinc LUT of the EWA Lanczos filter (frozen copy).

A copy, frozen for the benchmark's reference, of the host math that turns a
tap count into the radius and the 1024-entry squared-distance LUT of
AviSynth's JincResize (its src/JincResize.cpp:48-282: Taylor tables, jinc
zeros, piecewise ``jinc_sqr``, the asymptotic Bessel branch, ``sample_sqr``).
Plain NumPy float64, with SciPy's J1 for the mid range. The benchmark's
reference imports nothing of the program it judges, so it keeps this copy;
a change to the program's filter math does not change the yardstick.
"""

from __future__ import annotations

import numpy as np

# Taylor series coefficients of 2*J1(pi*x)/(pi*x) in powers of x^2 as x -> 0.
# Same mathematical constants as the reference table (JincResize.cpp:49-82);
# these are properties of the Bessel function, not code.
JINC_TAYLOR_SERIES = np.array(
    [
        1.0,
        -1.23370055013616982735431137,
        0.507339015802096027273126733,
        -0.104317403816764804365258186,
        0.0128696438477519721233840271,
        -0.00105848577966854543020422691,
        6.21835470803998638484476598e-05,
        -2.73985272294670461142756204e-06,
        9.38932725442064547796003405e-08,
        -2.57413737759717407304931036e-09,
        5.77402672521402031756429343e-11,
        -1.07930605263598241754572977e-12,
        1.70710316782347356046974552e-14,
        -2.31434518382749184406648762e-16,
        2.71924659665997312120515390e-18,
        -2.79561335187943028518083529e-20,
        2.53599244866299622352138464e-22,
        -2.04487273140961494085786452e-24,
        1.47529860450204338866792475e-26,
        -9.57935105257523453155043307e-29,
        5.62764317309979254140393917e-31,
        -3.00555258814860366342363867e-33,
        1.46559362903641161989338221e-35,
        -6.55110024064596600335624426e-38,
        2.69403199029404093412381643e-40,
        -1.02265499954159964097119923e-42,
        3.59444454568084324694180635e-45,
        -1.17313973900539982313119019e-47,
        3.56478606255557746426034301e-50,
        -1.01100655781438313239513538e-52,
        2.68232117541264485328658605e-55,
    ],
    dtype=np.float64,
)

# First 16 positive zeros of jinc(x) = 2*J1(pi*x)/(pi*x); ``radius =
# JINC_ZEROS[tap-1]`` (reference table at JincResize.cpp:84-102, use at :794).
JINC_ZEROS = np.array(
    [
        1.2196698912665045,
        2.2331305943815286,
        3.2383154841662362,
        4.2410628637960699,
        5.2427643768701817,
        6.2439216898644877,
        7.2447598687199570,
        8.2453949139520427,
        9.2458926849494673,
        10.246293348754916,
        11.246622794877883,
        12.246898461138105,
        13.247132522181061,
        14.247333735806849,
        15.247508563037300,
        16.247661874700962,
    ],
    dtype=np.float64,
)

# Square of the first jinc zero, used as the fixed window radius of the
# jinc-windowed-jinc (EWA Lanczos) kernel (JincResize.cpp:258).
JINC_ZERO_SQR = 1.48759464366204680005356

LUT_SIZE = 1024  # ``samples`` at JincResize.cpp:795 (and Lut::lut_size).


def _evaluate_rational(num: np.ndarray, denom: np.ndarray, z: float) -> float:
    """Horner evaluation of P(z)/Q(z) with the dual small/large-z form.

    Mirrors the boost-derived ``evaluate_rational`` (JincResize.cpp:110-140):
    ascending-order Horner in 1/z when z > 1 for numerical stability.
    """
    count = len(num)
    if z <= 1.0:
        s1 = num[count - 1]
        s2 = denom[count - 1]
        for i in range(count - 2, -1, -1):
            s1 = s1 * z + num[i]
            s2 = s2 * z + denom[i]
    else:
        z = 1.0 / z
        s1 = num[0]
        s2 = denom[0]
        for i in range(1, count):
            s1 = s1 * z + num[i]
            s2 = s2 * z + denom[i]
    return s1 / s2


# Boost-derived rational tables for the asymptotic J1 form (JincResize.cpp:150-189;
# originally Boost Math bessel_j1, (c) 2006 Xiaogang Zhang, Boost Software License).
_BPC = np.array(
    [
        -4.4357578167941278571e06,
        -9.9422465050776411957e06,
        -6.6033732483649391093e06,
        -1.5235293511811373833e06,
        -1.0982405543459346727e05,
        -1.6116166443246101165e03,
        0.0,
    ]
)
_BQC = np.array(
    [
        -4.4357578167941278568e06,
        -9.9341243899345856590e06,
        -6.5853394797230870728e06,
        -1.5118095066341608816e06,
        -1.0726385991103820119e05,
        -1.4550094401904961825e03,
        1.0,
    ]
)
_BPS = np.array(
    [
        3.3220913409857223519e04,
        8.5145160675335701966e04,
        6.6178836581270835179e04,
        1.8494262873223866797e04,
        1.7063754290207680021e03,
        3.5265133846636032186e01,
        0.0,
    ]
)
_BQS = np.array(
    [
        7.0871281941028743574e05,
        1.8194580422439972989e06,
        1.4194606696037208929e06,
        4.0029443582266975117e05,
        3.7890229745772202641e04,
        8.6383677696049909675e02,
        1.0,
    ]
)


def jinc_sqr_boost_l(x2: float) -> float:
    """Asymptotic large-argument jinc(sqrt(x2)) via the Boost J1 rational form.

    Matches ``jinc_sqr_boost_l`` (JincResize.cpp:148-198): used by the
    reference only for the 8-tap annulus, accurate to ~1e-16 for pi*sqrt(x2) > 8.
    """
    y2 = np.pi * np.pi * x2
    xp = np.sqrt(y2)
    y2p = 64.0 / y2
    sx = np.sin(xp)
    cx = np.cos(xp)
    return (np.sqrt(xp / np.pi) * 2.0 / y2) * (
        _evaluate_rational(_BPC, _BQC, y2p) * (sx - cx)
        + (8.0 / xp) * _evaluate_rational(_BPS, _BQS, y2p) * (sx + cx)
    )


def _jinc_taylor(x2: float, terms: int) -> float:
    """Horner evaluation of the jinc Taylor series in x^2 with ``terms`` terms."""
    res = 0.0
    for j in range(terms, 0, -1):
        res = res * x2 + JINC_TAYLOR_SERIES[j - 1]
    return res


def _j1(x: float) -> float:
    """Bessel J1 for the mid/large-range branches.

    The reference calls ``std::cyl_bessel_j(1, x)`` (JincResize.cpp:234, 243)
    here; we use scipy's Cephes J1, which agrees to within a few float64 ulps —
    well below the float32 coefficient quantization that follows.
    """
    from scipy.special import j1  # local import: host build-time only

    return float(j1(x))


def jinc_sqr(x2: float) -> float:
    """jinc(sqrt(x2)) = 2*J1(pi*sqrt(x2)) / (pi*sqrt(x2)).

    Piecewise evaluation with the reference's branch thresholds and term counts
    (JincResize.cpp:200-245): Taylor series near the origin (16/21/26/31 terms
    for the 1/2/3/4-tap radii), true Bessel J1 in the mid range, and the Boost
    asymptotic rational form for the 8-tap annulus.
    """
    if x2 < 1.49:
        return _jinc_taylor(x2, 16)
    elif x2 < 4.97:
        return _jinc_taylor(x2, 21)
    elif x2 < 10.49:
        return _jinc_taylor(x2, 26)
    elif x2 < 17.99:
        return _jinc_taylor(x2, 31)
    elif x2 < 52.57:
        x = np.pi * np.sqrt(x2)
        return 2.0 * _j1(x) / x
    elif x2 < 68.07:
        return jinc_sqr_boost_l(x2)
    else:
        x = np.pi * np.sqrt(x2)
        return 2.0 * _j1(x) / x


def sample_sqr(filter_fn, x2: float, blur2: float, radius2: float) -> float:
    """Radial sample with blur scaling and hard radius cutoff.

    Matches ``sample_sqr`` (JincResize.cpp:247-256): squared distance divided by
    blur^2, zero outside radius^2.
    """
    if blur2 > 0.0:
        x2 = x2 / blur2
    if x2 < radius2:
        return filter_fn(x2)
    return 0.0


def build_lut(radius: float, blur: float, lut_size: int = LUT_SIZE) -> np.ndarray:
    """Build the windowed-jinc LUT over normalized squared distance.

    ``lut[i] = jinc(r*t/blur) * jinc(sqrt(JINC_ZERO_SQR)*t)`` with
    ``t2 = i/(lut_size-1)`` — jinc-windowed jinc, i.e. EWA Lanczos — exactly as
    ``Lut::InitLut`` (JincResize.cpp:265-275). Returned as float64; consumers
    quantize to float32 at coefficient-gather time (``Lut::GetFactor``
    semantics, JincResize.cpp:277-282).
    """
    radius2 = radius * radius
    blur2 = blur * blur
    lut = np.empty(lut_size, dtype=np.float64)
    for i in range(lut_size):
        t2 = i / (lut_size - 1.0)
        lut[i] = sample_sqr(jinc_sqr, radius2 * t2, blur2, radius2) * sample_sqr(
            jinc_sqr, JINC_ZERO_SQR * t2, 1.0, radius2
        )
    return lut


def lut_get_factor(lut: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Vectorized ``Lut::GetFactor``: float32 of lut[index], 0 beyond the end.

    Indices are int64 and must be non-negative (the squared-distance index is
    by construction); anything >= len(lut) yields 0.0f (JincResize.cpp:277-282).
    """
    index = np.asarray(index)
    in_range = index < len(lut)
    safe = np.where(in_range, index, 0)
    vals = lut[safe].astype(np.float32)
    return np.where(in_range, vals, np.float32(0.0))
