"""Batched inverse-Lyndon (ICFL) factorization in plain PyTorch.

Counterpart of ``fpmash_tpu/ops/icfl.py`` and the plain version of the ICFL
half of kernel ``csrc/factor_words.cu`` (which replaces the Pallas kernel
``icfl_pallas.py:88 _icfl_words_kernel``).  The reference's per-string
recursion (lyn2vec/factorizations.py:143-248: ``find_pre`` ascent scan,
``find_bre`` bounded right extension, then an insert-or-prepend fold) runs
as one automaton per row, all rows stepping in lockstep:

* SCAN: the anti-order Duval scan ``w[j] <= w[i]`` over the current
  segment remainder ``w``.  The matched-prefix counter ``i`` at ``j`` is the
  longest proper border of ``w[:j]``, recorded as ``st[j] = i``.
* CHAIN: at the first ascent ``w[j] > w[i]`` the bounded right extension's
  bound is the smallest border ``b`` on the chain ``st[i], st[st[i]], ...``
  (its head ``i`` included) with ``w[b] < w[j]``; the level peels
  ``p = w[:j - b]`` and records ``(base + |p|, |p|, last = b)``, then the
  scan restarts on the rest.
* Merge: a backward fold over the recorded levels; a level is a factor
  boundary iff the running first-factor length exceeds its ``last``.

Each row walks an ordered list of disjoint segments (one whole-row segment
for ICFL, the long CFL factors for CFL_ICFL), ending each with a marker
level that resets the fold.  Unlike the JAX version there is no level
capacity and no step bound: the level record holds ``L + S`` entries, which
no row can exceed, and the loop ends when every row is done, so ``ok`` is
always true.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.lyndon import cfl_boundary_mask, pack_boundary_words, unpack_boundary_words

SCAN, CHAIN, ROWDONE = 0, 1, 2


def icfl_boundary_words(batch, seg_start, seg_len, nseg):
    """Run the ICFL automaton over per-row segment lists.

    ``batch`` is ``uint8[B, L]``; ``seg_start``/``seg_len`` are ``[B, S]``
    disjoint ascending segments, of which the first ``nseg[b]`` are used.
    Returns ``(words int32[B, ceil(L/32)], ok bool[B])``: factor-start bits
    *inside* the segments, without each segment's own start bit (the caller
    owns those).
    """
    B, L = batch.shape
    dev = batch.device
    S = seg_start.shape[1]
    i64 = dict(dtype=torch.int64, device=dev)
    seg_start = seg_start.to(**i64)
    seg_len = seg_len.to(**i64)
    nseg = nseg.to(**i64)
    chars = batch.to(torch.int16)
    LV = L + S + 1  # levels: < seg_len per segment, plus one marker each
    rows = torch.arange(B, device=dev)

    def sel(col):
        return chars[rows, col.clamp(0, max(L - 1, 0))]

    def seg_get(arr, idx):
        return arr[rows, idx.clamp(0, max(S - 1, 0))] if S else torch.zeros(B, **i64)

    zeros = torch.zeros(B, **i64)
    phase = torch.where(nseg > 0, SCAN, ROWDONE)
    seg_idx = zeros.clone()
    base = seg_get(seg_start, zeros)
    seg_n = seg_get(seg_len, zeros)
    i, j = zeros.clone(), zeros + 1
    jx, c, b, best = zeros.clone(), zeros.clone(), zeros.clone(), zeros.clone()
    st = torch.zeros((B, L + 1), **i64)  # column L: dump slot
    lev_bpos = torch.zeros((B, LV + 1), **i64)  # column LV: dump slot
    lev_plen = torch.zeros((B, LV + 1), **i64)
    lev_last = torch.zeros((B, LV + 1), **i64)
    lev_marker = torch.zeros((B, LV + 1), dtype=torch.bool, device=dev)
    nlev = zeros.clone()

    while L and not bool((phase == ROWDONE).all()):
        scanning = phase == SCAN
        chaining = phase == CHAIN
        s_i = sel(base + i)
        s_j = sel(base + j)

        # SCAN: record st[j] = i, stop at the segment's end or an ascent
        seg_end = j >= seg_n
        scan_live = scanning & ~seg_end
        ascent = scan_live & (s_j > s_i)
        st.scatter_(1, torch.where(scan_live, j, L)[:, None], i[:, None])
        finish = scanning & seg_end
        seg_idx_f = seg_idx + 1
        row_done = finish & (seg_idx_f >= nseg)

        # CHAIN: walk the border chain down to 0, keeping the smallest
        # border that precedes a character below the ascent's
        commit = chaining & (b <= 0)
        walk = chaining & (b > 0)
        b2 = st[rows, b.clamp(0, L)]
        best_w = torch.where(walk & (sel(base + b2) < c), b2, best)
        p_len = jx - best

        # a segment's finish records a marker, a commit records a level
        record = finish | commit
        col = torch.where(record, nlev, LV)[:, None]
        lev_bpos.scatter_(1, col, torch.where(finish, base, base + p_len)[:, None])
        lev_plen.scatter_(1, col, torch.where(finish, seg_n, p_len)[:, None])
        lev_last.scatter_(1, col, best[:, None])
        lev_marker.scatter_(1, col, finish[:, None])
        nlev = nlev + record

        restart = (finish & ~row_done) | commit
        advance = scan_live & ~ascent
        phase = torch.where(row_done, ROWDONE,
                            torch.where(record, SCAN, torch.where(ascent, CHAIN, phase)))
        base = torch.where(finish, torch.where(row_done, base, seg_get(seg_start, seg_idx_f)),
                           torch.where(commit, base + p_len, base))
        seg_n = torch.where(finish, torch.where(row_done, seg_n, seg_get(seg_len, seg_idx_f)),
                            torch.where(commit, seg_n - p_len, seg_n))
        jx = torch.where(ascent, j, jx)
        c = torch.where(ascent, s_j.to(torch.int64), c)
        b = torch.where(ascent, i, torch.where(walk, b2, b))
        best = torch.where(ascent, i, best_w)
        j = torch.where(restart, 1, torch.where(advance, j + 1, j))
        i = torch.where(restart, 0, torch.where(advance, torch.where(s_j == s_i, i + 1, 0), i))
        seg_idx = torch.where(finish, seg_idx_f, seg_idx)

    # merge: fold the levels backward; a marker resets the first-factor
    # length to its segment's remainder
    mask = torch.zeros((B, L + 1), dtype=torch.bool, device=dev)
    cur = zeros.clone()
    for m in range(int(nlev.max()) - 1 if B else -1, -1, -1):
        valid = m < nlev
        bpos, plen, last = lev_bpos[:, m], lev_plen[:, m], lev_last[:, m]
        marker = lev_marker[:, m]
        insert = valid & ~marker & (cur > last)
        mask.scatter_(1, torch.where(insert, bpos, L)[:, None], True)
        cur = torch.where(valid, torch.where(marker | insert, plen, plen + cur), cur)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    return pack_boundary_words(mask[:, :L]), ok


def icfl_boundary_mask(batch, lengths):
    """Plain ICFL factor-start mask, one whole-row segment per row:
    ``(mask bool[B, L], ok bool[B])``."""
    B, L = batch.shape
    n = lengths.to(device=batch.device, dtype=torch.int64)
    words, ok = icfl_boundary_words(batch, torch.zeros_like(n)[:, None], n[:, None],
                                    (n > 0).to(torch.int64))
    mask = unpack_boundary_words(words, n)[:, :L]
    if L:
        mask[:, 0] = n > 0  # the factorization starts at 0
    return mask, ok


def cfl_icfl_boundary_mask(batch, lengths, threshold: int = 30):
    """CFL_ICFL-T mask: Duval factors longer than ``threshold`` are
    sub-factorized with ICFL in place (factorizations.py:265-301; the
    ``<<``/``>>`` markers carry no length).  ``(mask bool[B, L], ok bool[B])``."""
    B, L = batch.shape
    dev = batch.device
    n = lengths.to(device=dev, dtype=torch.int64)
    cfl_mask = cfl_boundary_mask(batch, n)

    # the long factors as segments, compacted to the left
    iota = torch.arange(L, device=dev).expand(B, L)
    bpos = torch.where(cfl_mask, iota, L).sort(dim=1).values
    nxt = torch.cat([bpos[:, 1:], torch.full((B, 1), L, dtype=bpos.dtype, device=dev)], dim=1)
    flen = (torch.minimum(nxt, n[:, None]) - torch.minimum(bpos, n[:, None])).clamp(min=0)
    long = flen > threshold
    S = max(1, L // (threshold + 1))
    order = torch.argsort(torch.where(long, iota, L), dim=1, stable=True)[:, :S]
    seg_start = torch.where(long, bpos, 0).gather(1, order)
    seg_len = torch.where(long, flen, 0).gather(1, order)
    nseg = long.sum(dim=1)

    words, ok = icfl_boundary_words(batch, seg_start, seg_len, nseg)
    return cfl_mask | unpack_boundary_words(words, n)[:, :L], ok
