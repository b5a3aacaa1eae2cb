"""Mash distance, its p-values, and C++-style number formatting.

Copies of :func:`fpmash_tpu.models.distance.mash_distance` and the parts of
:mod:`fpmash_tpu.scalar.stats` that ``dist``, ``triangle`` and ``screen``
need.  ``binom_sf`` is GSL's ``gsl_cdf_binomial_Q`` (CommandDistance.cpp:433-450,
CommandScreen.cpp:386-406), ``binom_cdf`` its ``gsl_cdf_binomial_P``
(``bounds``, CommandBounds.cpp:148-170) and ``chisq_sf`` its
``gsl_cdf_chisq_Q`` (CommandTriangle.cpp:297); SciPy computes them through the regularized
incomplete beta and gamma functions, agreeing with GSL at full double
precision even in the extreme tails the goldens exercise (e.g. 4.48626e-214).
"""

from __future__ import annotations

import math


def mash_distance(jaccard: float, kmer_size: int) -> float:
    """d = -ln(2j/(1+j))/k, clamped (CommandDistance.cpp:403-414)."""
    if jaccard == 1.0:
        return 0.0
    if jaccard == 0.0:
        return 1.0
    d = -math.log(2.0 * jaccard / (1.0 + jaccard)) / kmer_size
    return min(d, 1.0)


def binom_sf(k: int, n: int, p: float) -> float:
    """P(X > k) for X ~ Binomial(n, p) — i.e. gsl_cdf_binomial_Q(k, p, n)."""
    if n <= 0 or p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0 if k < n else 0.0
    if k < 0:
        return 1.0
    if k >= n:
        return 0.0
    from scipy.stats import binom

    return float(binom.sf(k, n, p))


def binom_cdf(k: int, n: int, p: float) -> float:
    """P(X <= k) — gsl_cdf_binomial_P(k, p, n)."""
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0
    from scipy.stats import binom

    return float(binom.cdf(k, n, p))


def chisq_sf(x, df: float = 1.0):
    """P(X > x) for chi-square — gsl_cdf_chisq_Q(x, df).  A float for a
    number; an array of the same values, elementwise, for an array."""
    from scipy.stats import chi2

    out = chi2.sf(x, df)
    return float(out) if out.ndim == 0 else out


def mash_pvalue(
    common: int, length_ref: int, length_query: int, kmer_space: float, sketch_size: int
) -> float:
    """Binomial p-value for observing ``common`` shared min-hashes by chance
    (CommandDistance.cpp:433-450 ``pValue``)."""
    if common == 0:
        return 1.0
    px = 1.0 / (1.0 + kmer_space / length_ref)
    py = 1.0 / (1.0 + kmer_space / length_query)
    r = px * py / (px + py - px * py)
    return binom_sf(common - 1, sketch_size, r)


def screen_pvalue(common: int, set_size: int, kmer_space: float, sketch_size: int) -> float:
    """`pValueWithin` (CommandScreen.cpp:386-406)."""
    if common == 0:
        return 1.0
    r = float(set_size) / kmer_space
    r = max(0.0, min(1.0, r))
    return binom_sf(common - 1, sketch_size, r)


def format_g(x: float) -> str:
    """C++ ``cout << double`` default formatting (6 significant digits)."""
    return f"{x:g}"
