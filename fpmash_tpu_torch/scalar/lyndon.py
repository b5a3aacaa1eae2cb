"""Lyndon / inverse-Lyndon factorizations — scalar parity models.

Copy of :mod:`fpmash_tpu.scalar.lyndon` (the port cannot import the JAX
package), the oracle every factorization kernel of the port is held
against.  The factorization families of the reference's lyn2vec front-end
(lyn2vec/factorizations.py and factorizations_comb.py), validated against
the golden fingerprint files in tests/golden:

* CFL — Chen–Fox–Lyndon factorization via Duval's algorithm (Duval 1983).
* ICFL — inverse-Lyndon factorization via bounded-right-extension recursion
  (Bonomo, Bonizzoni, De Felice, Zaccagnino, Zizza — "Inverse Lyndon words
  and inverse Lyndon factorizations of words").
* CFL_ICFL — Duval CFL where factors longer than a threshold ``C`` are
  sub-factorized with ICFL (reference factorizations.py:265-301); with
  ``sep=True`` the sub-factorization is wrapped in ``<<``/``>>`` markers.
* *_COMB ("double") variants — the common refinement of the factorization of
  a sequence and the reversed factorization of its reverse complement
  (reference factorizations_comb.py:178-246).

Reference quirks that are intentionally preserved (load-bearing for golden
parity):

* In the COMB merge (:func:`d_combine`), the reverse-complement side calls
  the factorizer *without* the threshold argument, so ``d_cfl_icfl(seq, 10)``
  uses ``C=10`` on the forward strand but the default ``C=30`` on the
  reverse-complement strand (reference factorizations_comb.py:213-221).
* ``CFL(word, T)`` and ``ICFL(word, T)`` accept and ignore ``T``
  (reference factorizations.py:102,143) — mirrored by the ``FACTORIZATIONS``
  dispatch table which matches lyn2vec.py:47-72 name-for-name.
"""

from __future__ import annotations

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def reverse_complement(seq: str) -> str:
    """Reverse complement; unknown characters map to themselves as 'N'.

    (Reference factorizations_comb.py:8-10 raises KeyError on non-ACGTN;
    we degrade gracefully to 'N' instead, which cannot change any golden
    since the goldens only contain ACGT.)
    """
    return "".join(_COMPLEMENT.get(c, "N") for c in reversed(seq))


def cfl(word: str, T=None) -> list[str]:
    """Chen–Fox–Lyndon factorization by Duval's algorithm, O(n).

    Returns the unique factorization of ``word`` into a non-increasing
    sequence of Lyndon words.  Parity target: reference factorizations.py:102
    (``CFL``) and factorizations_comb.py:22 (``duval_``), verified equal on
    random DNA.
    """
    factors = []
    n = len(word)
    i = 0
    while i < n:
        # Scan the maximal prefix of word[i:] that is a power of a Lyndon
        # word: j runs ahead, k trails the period start.
        j = i + 1
        k = i
        while j < n and word[k] <= word[j]:
            k = i if word[k] < word[j] else k + 1
            j += 1
        period = j - k
        while i <= k:
            factors.append(word[i : i + period])
            i += period
    return factors


def _failure(s: str) -> list[int]:
    """KMP failure function: f[i] = length of longest proper border of s[:i+1]."""
    f = [0] * len(s)
    k = 0
    for i in range(1, len(s)):
        while k > 0 and s[k] != s[i]:
            k = f[k - 1]
        if s[k] == s[i]:
            k += 1
        f[i] = k
    return f


def _first_ascent_prefix(w: str):
    """Split ``w = x + y`` at its first "ascent", or None if none exists.

    ``x`` is the shortest prefix that is *not* an inverse Lyndon word (it
    ends one character past the first position where a character strictly
    exceeds the one it is compared against in the Duval-style scan); ``y``
    is the remainder.  Returns ``(None, None)`` when ``w`` itself is an
    inverse Lyndon word.  Mirrors reference factorizations_comb.py:48-79.
    """
    n = len(w)
    if n == 1:
        return None, None
    i = 0
    j = 1
    while j < n - 1 and w[j] <= w[i]:
        i = 0 if w[j] < w[i] else i + 1
        j += 1
    if j == n - 1 and w[j] <= w[i]:
        return None, None
    return w[: j + 1], w[j + 1 :]


def _bounded_right_extension(x: str, y: str):
    """Given ``w = x + y`` with ``x = p·p'`` not inverse Lyndon, compute
    ``(p, p', y, last)`` where ``p'`` is the bounded right extension of the
    inverse Lyndon prefix ``p`` in ``w`` and ``last = |r|`` for ``x = raurb``.

    Mirrors reference factorizations_comb.py:82-102.
    """
    w = x + y
    n = len(x) - 1
    f = _failure(x[:-1])
    i = n - 1
    last = n
    while i >= 0:
        if w[f[i]] < x[-1]:
            last = f[i] - 1
        i = f[i] - 1
    return w[: n - last - 1], w[n - last - 1 : n + 1], y, last + 1


def icfl(word: str, T=None) -> list[str]:
    """Inverse-Lyndon factorization (ICFL).

    Parity target: reference factorizations.py:143 (``ICFL_recursive``) and
    factorizations_comb.py:133 (``icfl_``), verified equal on random DNA.
    Implemented iteratively (the reference recurses per factor, which can
    overflow Python's stack on long homogeneous inputs).
    """
    # Each recursion level peels an inverse-Lyndon prefix p off the front and
    # then merges it with the factorization of the rest depending on |m1'|
    # vs |r|; we unroll that recursion into an explicit stack of (p, last).
    stack = []
    w = word
    while True:
        x, y = _first_ascent_prefix(w)
        if x is None:
            result = [w]
            break
        p, bre, y, last = _bounded_right_extension(x, y)
        stack.append((p, last))
        w = bre + y
    for p, last in reversed(stack):
        if len(result[0]) > last:
            result.insert(0, p)
        else:
            result[0] = p + result[0]
    return result


def cfl_icfl(word: str, C: int = 30, sep: bool = False) -> list[str]:
    """Duval CFL with ICFL sub-factorization of factors longer than ``C``.

    With ``sep=True`` each sub-factorization is wrapped in ``<<``/``>>``
    markers (reference factorizations.py:265-301 ``CFL_icfl``); with
    ``sep=False`` it is spliced in flat (reference factorizations_comb.py:164
    ``cfl_icfl_``).  The two reference variants are otherwise identical.
    """
    if C is None:
        C = 30
    result = []
    for factor in cfl(word):
        if len(factor) > C:
            sub = icfl(factor)
            if sep:
                result.append("<<")
                result.extend(sub)
                result.append(">>")
            else:
                result.extend(sub)
        else:
            result.append(factor)
    return result


def d_combine(seq: str, alg, T=None) -> list[str]:
    """COMB ("double") factorization: common refinement of ``alg(seq)`` and
    the reversed ``alg(reverse_complement(seq))``.

    Mirrors reference factorizations_comb.py:213-246 (``d_duval_``)
    including its quirk: the reverse-complement side is factorized *without*
    the threshold argument (so CFL_ICFL_COMB-T uses the default C=30 there).
    """
    if T is None:
        fwd = [len(f) for f in alg(seq)]
    else:
        fwd = [len(f) for f in alg(seq, T)]
    rc = [len(f) for f in reversed(alg(reverse_complement(seq)))]

    # Merge the two boundary sets front-to-back, slicing seq at each cut.
    result = []
    rest = seq
    i = 0
    j = 0
    # Work on copies since we mutate heads during the refinement walk.
    fwd = list(fwd)
    rc = list(rc)
    while fwd and rc:
        if fwd[0] < rc[0]:
            n = fwd.pop(0)
            rc[0] -= n
            if rc[0] == 0:
                rc.pop(0)
        else:
            n = rc.pop(0)
            fwd[0] -= n
            if fwd[0] == 0:
                fwd.pop(0)
        result.append(rest[:n])
        rest = rest[n:]
    for n in fwd + rc:
        result.append(rest[:n])
        rest = rest[n:]
    return result


def d_cfl(seq: str, T=None) -> list[str]:
    """CFL_COMB (reference factorizations_comb.py:189)."""
    return d_combine(seq, cfl)


def d_icfl(seq: str, T=None) -> list[str]:
    """ICFL_COMB (reference factorizations_comb.py:193)."""
    return d_combine(seq, icfl)


def d_cfl_icfl(seq: str, T=30) -> list[str]:
    """CFL_ICFL_COMB-T (reference factorizations_comb.py:203)."""
    return d_combine(seq, cfl_icfl, T)


def _cfl_icfl_sep(T):
    def run(word, _T=None):
        return cfl_icfl(word, T, sep=True)

    return run


#: Factorization name -> callable(word, T) dispatch, matching the reference
#: CLI's table (lyn2vec/lyn2vec.py:47-72).  Callables take (word, T_ignored)
#: with the threshold already bound, and return a factor list which may
#: contain '<<'/'>>' markers (stripped by the fingerprint pipeline).
FACTORIZATIONS = {
    "CFL": lambda w, T=None: cfl(w),
    "ICFL": lambda w, T=None: icfl(w),
    "CFL_ICFL-10": _cfl_icfl_sep(10),
    "CFL_ICFL-20": _cfl_icfl_sep(20),
    "CFL_ICFL-30": _cfl_icfl_sep(30),
    "CFL_COMB": lambda w, T=None: d_cfl(w),
    "ICFL_COMB": lambda w, T=None: d_icfl(w),
    "CFL_ICFL_COMB-10": lambda w, T=None: d_cfl_icfl(w, 10),
    "CFL_ICFL_COMB-20": lambda w, T=None: d_cfl_icfl(w, 20),
    "CFL_ICFL_COMB-30": lambda w, T=None: d_cfl_icfl(w, 30),
}
