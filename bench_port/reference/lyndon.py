"""Lyndon factorizations of many short words at once, in plain PyTorch, with
a scalar walk of each for the tests.

* CFL: the Chen-Fox-Lyndon factorization by Duval's algorithm (Duval 1983,
  "Factorizing words over an ordered alphabet").
* ICFL: the inverse Lyndon factorization of Bonizzoni, De Felice, Zaccagnino
  and Zizza ("Inverse Lyndon words and inverse Lyndon factorizations of
  words", 2018), computed as fp-mash's lyn2vec does: peel the longest
  inverse Lyndon prefix's bounded right extension, recurse on the rest,
  then merge each peeled prefix into the first factor or put it in front.
* ``*_COMB``: the common refinement of a word's factorization and the
  mirrored factorization of its reverse complement (lyn2vec
  ``factorizations_comb.py``): a factor starts wherever either one has a
  factor start.

The batched versions step every word's state machine together, one
comparison a step, and drop finished words from the batch as they go.
They return factor starts as a ``bool [B, W]`` mask.
"""

from __future__ import annotations

import torch

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


# ---------------------------------------------------------------- scalar walks


def cfl_scalar(w: str) -> list[int]:
    """Factor lengths of ``w`` by Duval's algorithm."""
    out, i, n = [], 0, len(w)
    while i < n:
        j, k = i + 1, i
        while j < n and w[k] <= w[j]:
            k = i if w[k] < w[j] else k + 1
            j += 1
        while i <= k:
            out.append(j - k)
            i += j - k
    return out


def _failure(s: str) -> list[int]:
    f, k = [0] * len(s), 0
    for t in range(1, len(s)):
        while k > 0 and s[k] != s[t]:
            k = f[k - 1]
        if s[k] == s[t]:
            k += 1
        f[t] = k
    return f


def icfl_scalar(w: str) -> list[int]:
    """Factor lengths of ``w``'s inverse Lyndon factorization."""
    stack, off, n = [], 0, len(w)
    while True:
        s = w[off:]
        m = len(s)
        if m == 1:
            break
        i, j = 0, 1
        while j < m - 1 and s[j] <= s[i]:
            i = 0 if s[j] < s[i] else i + 1
            j += 1
        if j == m - 1 and s[j] <= s[i]:
            break
        f = _failure(s[:j])
        ii, last = j - 1, j
        while ii >= 0:
            if s[f[ii]] < s[j]:
                last = f[ii] - 1
            ii = f[ii] - 1
        plen = j - last - 1
        if plen <= 0:
            raise ValueError(f"no inverse Lyndon prefix to peel off {s!r}")
        stack.append((plen, last + 1))
        off += plen
    lengths = [n - off]
    for plen, bound in reversed(stack):
        if lengths[0] > bound:
            lengths.insert(0, plen)
        else:
            lengths[0] += plen
    return lengths


def reverse_complement(w: str) -> str:
    return "".join(_COMPLEMENT.get(c, "N") for c in reversed(w))


def comb_scalar(w: str, factorize) -> list[int]:
    """Factor lengths of the common refinement of ``factorize(w)`` and the
    mirrored ``factorize`` of ``w``'s reverse complement."""
    cuts = set()
    pos = 0
    for n in factorize(w):
        cuts.add(pos)
        pos += n
    pos = len(w)
    for n in factorize(reverse_complement(w)):
        pos -= n
        cuts.add(pos)
    cuts = sorted(cuts) + [len(w)]
    return [b - a for a, b in zip(cuts, cuts[1:])]


SCALAR = {
    "CFL": cfl_scalar,
    "ICFL": icfl_scalar,
    "CFL_COMB": lambda w: comb_scalar(w, cfl_scalar),
    "ICFL_COMB": lambda w: comb_scalar(w, icfl_scalar),
}


# ---------------------------------------------------------------- batched


class _Batch:
    """State tensors of the words still running, with the rows they are."""

    def __init__(self, words: torch.Tensor, lengths: torch.Tensor, **state):
        self.rows = torch.arange(words.shape[0], device=words.device)
        self.words, self.n = words, lengths
        self.state = state

    def __getattr__(self, name):
        return self.__dict__["state"][name]

    def set(self, **state):
        self.state.update(state)

    def keep(self, alive: torch.Tensor) -> None:
        idx = torch.nonzero(alive).squeeze(1)
        self.rows, self.words, self.n = self.rows[idx], self.words[idx], self.n[idx]
        self.state = {k: v[idx] for k, v in self.state.items()}

    def at(self, pos: torch.Tensor) -> torch.Tensor:
        """The letter at ``pos`` of each word (``pos`` clamped into it)."""
        pos = pos.clamp(0, self.words.shape[1] - 1)
        return self.words.gather(1, pos[:, None]).squeeze(1)


def _put(table: torch.Tensor, rows, cols, values, where) -> None:
    """``table[rows[i], cols[i]] = values[i]`` where ``where[i]``, with no
    wait for the device (each row at most once; ``cols`` clamped into it)."""
    cols = cols.clamp(0, table.shape[1] - 1)
    table[rows, cols] = torch.where(where, values, table[rows, cols])


#: steps between two drops of the finished words from a batch (each drop waits for the card)
CHECK_EVERY = 16


def cfl_marks(words: torch.Tensor, lengths: torch.Tensor):
    """Factor starts of each word ``words[b, :lengths[b]]`` by Duval's algorithm."""
    B, W = words.shape
    marks = torch.zeros(B, W, dtype=torch.bool, device=words.device)
    z = torch.zeros(B, dtype=torch.int64, device=words.device)
    bt = _Batch(words.to(torch.int64), lengths.to(torch.int64),
                i=z.clone(), j=z + 1, k=z.clone(), p=z.clone(), emit=z.bool())
    bt.keep(bt.n > 0)
    step = 0
    while bt.rows.numel():
        i, j, k, p, emit = bt.i, bt.j, bt.k, bt.p, bt.emit
        a, c = bt.at(j), bt.at(k)
        scan = ~emit & (i < bt.n)
        go = scan & (j < bt.n) & (c <= a)
        stop = scan & ~go
        # emitting: one factor of the period a step
        _put(marks, bt.rows, i, emit, emit)
        i2 = torch.where(emit, i + p, i)
        back = emit & (i2 > k)
        bt.set(
            i=i2,
            j=torch.where(go, j + 1, torch.where(back, i2 + 1, j)),
            k=torch.where(go, torch.where(c < a, i, k + 1), torch.where(back, i2, k)),
            p=torch.where(stop, j - k, p),
            emit=(emit & ~back) | stop,
        )
        step += 1
        if step % CHECK_EVERY == 0:
            bt.keep(bt.emit | (bt.i < bt.n))
    return marks


_SCAN, _FAIL, _CHAIN, _DONE = 0, 1, 2, 3


def icfl_marks(words: torch.Tensor, lengths: torch.Tensor):
    """Factor starts of each word's inverse Lyndon factorization, as
    :func:`icfl_scalar` finds them."""
    B, W = words.shape
    dev = words.device
    marks = torch.zeros(B, W, dtype=torch.bool, device=dev)
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    zw = torch.zeros(B, W, dtype=torch.int64, device=dev)
    n = lengths.to(torch.int64)
    # every word's peeled prefixes: offsets and bounds by depth, and where it ended
    offs, bounds, depth_of, final_off = zw.clone(), zw.clone(), z.clone(), z.clone()
    bt = _Batch(words.to(torch.int64), n.clone(),
                phase=torch.where(n <= 1, _DONE, _SCAN), off=z.clone(), i=z.clone(),
                j=z + 1, t=z.clone(), kk=z.clone(), jj=z.clone(), ii=z.clone(),
                last=z.clone(), d=z.clone(), f=zw.clone())
    bt.keep(bt.phase != _DONE)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    step = 0
    while bt.rows.numel():
        s = bt.state
        off, ph = s["off"], s["phase"]
        m = bt.n - off
        rows_all = torch.arange(bt.rows.numel(), device=dev)
        # --- scan for the first ascent
        scan = ph == _SCAN
        a, c = bt.at(off + s["j"]), bt.at(off + s["i"])
        go = scan & (s["j"] < m - 1) & (a <= c)
        whole = scan & ~go & (s["j"] == m - 1) & (a <= c)
        ascent = scan & ~go & ~whole
        i_new = torch.where(go, torch.where(a < c, 0, s["i"] + 1), s["i"])
        j_new = torch.where(go, s["j"] + 1, s["j"])
        # --- failure function of the prefix before the ascent
        fail = ph == _FAIL
        t, kk, jj = s["t"], s["kk"], s["jj"]
        ft = fail & (t < jj)
        st, sk = bt.at(off + t), bt.at(off + kk)
        fall = ft & (kk > 0) & (sk != st)
        fprev = s["f"].gather(1, (kk - 1).clamp(min=0)[:, None]).squeeze(1)
        adv = ft & ~fall
        kk_new = torch.where(fall, fprev, torch.where(adv, kk + (sk == st).long(), kk))
        # in place: this step reads f only at rows in other phases or below t
        _put(s["f"], rows_all, t, kk_new, adv)
        t_new = torch.where(adv, t + 1, t)
        to_chain = fail & (t >= jj)
        # --- the chain of borders: the bounded right extension
        chain = ph == _CHAIN
        ii, last = s["ii"], s["last"]
        walk = chain & (ii >= 0)
        fi = s["f"].gather(1, ii.clamp(min=0)[:, None]).squeeze(1)
        lower = walk & (bt.at(off + fi) < bt.at(off + jj))
        last_new = torch.where(lower, fi - 1, last)
        ii_new = torch.where(walk, fi - 1, ii)
        peel = chain & (ii < 0)
        plen = jj - last - 1
        bad |= (peel & (plen <= 0)).any()
        d = s["d"]
        _put(offs, bt.rows, d, off, peel)
        _put(bounds, bt.rows, d, last + 1, peel)
        off_new = torch.where(peel, off + plen, off)
        m_new = bt.n - off_new
        phase = torch.where(
            whole, _DONE,
            torch.where(ascent, _FAIL,
                        torch.where(to_chain, _CHAIN,
                                    torch.where(peel, torch.where(m_new <= 1, _DONE, _SCAN), ph))))
        bt.set(
            phase=phase, off=off_new, t=torch.where(ascent, 1, t_new),
            kk=torch.where(ascent, 0, kk_new), jj=torch.where(ascent, s["j"], jj),
            i=torch.where(peel, 0, i_new), j=torch.where(peel, 1, j_new),
            ii=torch.where(to_chain, jj - 1, ii_new),
            last=torch.where(to_chain, jj, last_new), d=torch.where(peel, d + 1, d),
        )
        step += 1
        if step % CHECK_EVERY == 0:
            if bool(bad):
                raise ValueError("no inverse Lyndon prefix to peel off a word")
            done = bt.phase == _DONE
            if bool(done.any()):
                depth_of[bt.rows[done]] = bt.d[done]
                final_off[bt.rows[done]] = bt.off[done]
                bt.keep(~done)
    # merge the peeled prefixes, deepest first, into the factors of the rest
    first_start, first_end = final_off.clone(), n.clone()
    all_rows = torch.arange(B, device=dev)
    for dd in range(int(depth_of.max()) if B else 0, 0, -1):
        live = depth_of >= dd
        o = offs[:, dd - 1]
        front = live & (first_end - first_start > bounds[:, dd - 1])
        _put(marks, all_rows, first_start, front, front)
        first_end = torch.where(front, first_start, first_end)
        first_start = torch.where(live, o, first_start)
    marks[:, 0] |= n > 0
    return marks


def mirror(marks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Factor starts of a factorization of the reverse word, seen on the word:
    a factor ``[a, b)`` of the reverse is ``[n - b, n - a)`` here."""
    B, W = marks.shape
    pos = torch.arange(W, device=marks.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    # a start at a in the reverse ends a factor at n - a here, so n - a starts one
    src = (n - pos).clamp(0, W - 1)
    ends = marks.gather(1, src) & (pos >= 1) & (pos < n)
    ends[:, 0] = lengths > 0
    return ends


def reverse_complement_rows(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's first ``lengths[b]`` letters reverse-complemented (A-T, C-G)."""
    table = torch.arange(256, dtype=torch.int64, device=words.device)
    for x, y in (b"AT", b"TA", b"CG", b"GC"):
        table[x] = y
    B, W = words.shape
    pos = torch.arange(W, device=words.device)[None, :]
    n = lengths.to(torch.int64)[:, None]
    src = (n - 1 - pos).clamp(0, W - 1)
    out = table[words.to(torch.int64).gather(1, src)]
    return torch.where(pos < n, out, 0)


BATCHED = {"CFL": cfl_marks, "ICFL": icfl_marks}


def factor_marks(family: str, words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Factor starts of each word under ``family`` (CFL, ICFL, CFL_COMB, ICFL_COMB)."""
    base, _, comb = family.partition("_")
    if base not in BATCHED or comb not in ("", "COMB"):
        raise ValueError(f"no batched reference for the family {family!r}")
    marks = BATCHED[base](words, lengths)
    if comb:
        rc = BATCHED[base](reverse_complement_rows(words, lengths), lengths)
        marks |= mirror(rc, lengths)
    return marks
