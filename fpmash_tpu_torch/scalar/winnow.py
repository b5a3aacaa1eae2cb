"""Scalar parity model of windowed min-hash ("minmer") selection (copy of
:mod:`fpmash_tpu.scalar.winnow`, the oracle of ``ops/winnow.py``).

Reimplements the semantics of ``getMinHashPositions`` (reference
Sketch.cpp:737-1047): slide a window of ``window_size`` consecutive k-mer
start positions across a sequence's per-position hashes; a position is a
*minmer* if, in any window that contains it, its hash is among the bottom
``mins`` *distinct* hash values of that window AND it is the earliest
occurrence of that hash value within the window.  Results are emitted as
``(position, hash)`` pairs in increasing position order (the reference
emits each position exactly once, when it leaves the sliding window).

The reference's incremental structure is an ordered map of
hash -> deque-of-candidate-positions plus an iterator pinned at the
``mins``-th smallest key ("maxMinmer"); candidates are flagged at four
event kinds (first full window, qualifying insertion, front promotion of a
repeated hash, and boundary advance when a hash leaves the window).  This
model mirrors those events exactly, using a bisect-maintained sorted key
list in place of the map iterator.

Notes carried over from the reference:
* invalid-character skipping is disabled (the skip is commented out at
  Sketch.cpp:810-815), so *every* position gets a hash;
* hashes come from MurmurHash3 over the raw bytes at each position — no
  case folding, no canonicalization (getMinHashPositions hashes
  ``seq + i`` directly, Sketch.cpp:837);
* the window is clamped to the number of k-mer positions
  (Sketch.cpp:748-751).
"""

from __future__ import annotations

from bisect import bisect_left, insort


def minmer_position_hashes(
    hashes: list[int], window_size: int, mins: int
) -> list[tuple[int, int]]:
    """Return [(position, hash)] minmers for per-position ``hashes``.

    ``hashes[i]`` is the hash of the k-mer starting at position ``i``;
    ``window_size`` counts k-mer start positions; ``mins`` is the bottom-k
    budget of distinct hash values per window.
    """
    n = len(hashes)
    if n == 0:
        return []
    ws = min(window_size, n)

    # hash -> list of [position, flagged] candidates, earliest first
    deques: dict[int, list[list]] = {}
    sorted_keys: list[int] = []
    # the "mins-th smallest distinct key" marker; None plays the role of
    # the reference's end() iterator (fewer than `mins` distinct keys)
    max_minmer: int | None = None
    # rolling window of the hash pushed at each step (pop in push order)
    window: list[int] = []
    out: list[tuple[int, int]] = []

    def pred(key: int) -> int | None:
        i = bisect_left(sorted_keys, key)
        return sorted_keys[i - 1] if i > 0 else None

    def succ(key: int) -> int | None:
        i = bisect_left(sorted_keys, key) + 1
        return sorted_keys[i] if i < len(sorted_keys) else None

    for i in range(n):
        h = hashes[i]

        # --- insert the new candidate -------------------------------- #
        newly = h not in deques
        if newly:
            deques[h] = []
            insort(sorted_keys, h)
        deques[h].append([i, False])
        if newly and (
            (max_minmer is None and len(sorted_keys) == mins)
            or (max_minmer is not None and h < max_minmer)
        ):
            # the marker retreats one key (reference maxMinmer--)
            max_minmer = pred(max_minmer) if max_minmer is not None else sorted_keys[-1]

        window.append(h)

        # --- pop the front of the window if it is full size ----------- #
        if len(window) > ws:
            hfront = window.pop(0)
            dq = deques[hfront]
            if dq[0][1]:
                out.append((dq[0][0], hfront))
            if len(dq) > 1:
                dq.pop(0)
                # promoted front of a repeated hash: flag if it qualifies
                if max_minmer is None or (i >= ws and hfront <= max_minmer):
                    dq[0][1] = True
            else:
                # the hash leaves the window; the marker advances past it
                if max_minmer is not None and hfront <= max_minmer:
                    max_minmer = succ(max_minmer)
                    if max_minmer is not None:
                        deques[max_minmer][0][1] = True
                del deques[hfront]
                sorted_keys.pop(bisect_left(sorted_keys, hfront))

        # --- first complete window: flag the current bottom set ------- #
        if i == ws - 1:
            for key in sorted_keys:
                deques[key][0][1] = True
                if key == max_minmer:
                    break

        # --- flag the just-pushed candidate if it qualifies ----------- #
        if i >= ws and (max_minmer is None or h <= max_minmer):
            deques[h][0][1] = True

    # --- drain: emit flagged fronts of what remains in the window ----- #
    for hfront in window:
        dq = deques.get(hfront)
        if dq:
            if dq[0][1]:
                out.append((dq[0][0], hfront))
            dq.pop(0)
            if not dq:
                del deques[hfront]

    return out
