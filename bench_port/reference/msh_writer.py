"""A plain writer of Mash's ``.msh`` files, for the benchmark's own inputs.

It writes the layout that ``reference/msh.py`` reads (Mash's schema
``MinHash.capnp``): one segment; the root ``MinHash`` struct (3 data words,
4 pointers) at word 1; its reference list (``referenceListOld`` where the
seed is 42, as Mash writes it, else ``referenceList``) as a struct of one
pointer to a composite list of ``Reference`` structs (2 data words, 7
pointers: ``length64`` set, the u32 ``length`` left 0, as Mash writes it);
then each reference's name, comment and ``hashes64`` in reference order;
then the alphabet.  No locus list, no counts, no 32-bit hashes.
"""

from __future__ import annotations

import struct

import numpy as np


def _struct_ptr(at: int, target: int, dw: int, pw: int) -> int:
    return ((target - at - 1) << 2) | (dw << 32) | (pw << 48)


def _list_ptr(at: int, target: int, esize: int, count: int) -> int:
    return 1 | ((target - at - 1) << 2) | (esize << 32) | (count << 35)


def _text(s: str) -> bytes:
    return s.encode("utf-8") + b"\0"


def msh_bytes(*, kmer: int, sketch_size: int, seed: int, alphabet: str, canonical: bool,
              names: list[str], comments: list[str], lengths, hashes: np.ndarray,
              seg_len) -> bytes:
    """The file of ``len(names)`` references whose 64-bit hashes are
    ``hashes[sum(seg_len[:i]) :][: seg_len[i]]`` (each ascending)."""
    n = len(names)
    seg_len = np.asarray(seg_len, np.int64)
    texts = [(_text(a), _text(b)) for a, b in zip(names, comments)]
    alpha = _text(alphabet)
    # word positions: 0 root pointer, 1-3 root data, 4-7 root pointers, 8 the
    # list holder, 9 the list's tag, 10.. the references, then the payloads
    elem0 = 10
    pos = elem0 + 9 * n
    places = []
    for (name, comment), h in zip(texts, seg_len.tolist()):
        places.append((pos, pos + (len(name) + 7) // 8))
        pos = places[-1][1] + (len(comment) + 7) // 8
        pos += h
    alpha_at = pos
    total = alpha_at + (len(alpha) + 7) // 8
    w = np.zeros(total, np.uint64)
    b = w.view(np.uint8)
    w[0] = _struct_ptr(0, 1, 3, 4)
    w[1] = kmer
    w[2] = sketch_size | (1 << 32) | ((not canonical) << 33)  # concatenated, noncanonical
    w[3] = struct.unpack("<I", struct.pack("<f", 0.0))[0] | ((seed ^ 42) << 32)
    slot = 4 + (0 if seed == 42 else 3)
    w[slot] = _struct_ptr(slot, 8, 0, 1)
    w[6] = _list_ptr(6, alpha_at, 2, len(alpha))
    w[8] = _list_ptr(8, 9, 7, 9 * n)
    w[9] = (n << 2) | (2 << 32) | (7 << 48)
    start = 0
    for i, ((name, comment), (name_at, comment_at), h) in enumerate(
            zip(texts, places, seg_len.tolist())):
        e = elem0 + 9 * i
        w[e + 1] = int(lengths[i])
        p = e + 2  # the pointers
        w[p + 2] = _list_ptr(p + 2, name_at, 2, len(name))
        w[p + 3] = _list_ptr(p + 3, comment_at, 2, len(comment))
        b[8 * name_at : 8 * name_at + len(name)] = np.frombuffer(name, np.uint8)
        b[8 * comment_at : 8 * comment_at + len(comment)] = np.frombuffer(comment, np.uint8)
        hashes_at = comment_at + (len(comment) + 7) // 8
        if h:
            w[p + 5] = _list_ptr(p + 5, hashes_at, 5, h)
            w[hashes_at : hashes_at + h] = hashes[start : start + h]
        start += h
    b[8 * alpha_at : 8 * alpha_at + len(alpha)] = np.frombuffer(alpha, np.uint8)
    return struct.pack("<II", 0, total) + w.tobytes()
