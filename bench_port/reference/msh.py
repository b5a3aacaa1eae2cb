"""A reader of Mash's ``.msh`` files, frozen here as part of the yardstick.

A ``.msh`` is a Cap'n Proto message of Mash's schema ``MinHash.capnp``: a
segment table (count - 1, then each segment's size in words), then the
segments.  The root ``MinHash`` struct has ``kmerSize`` (u32 at data word 0),
``windowSize`` (u32, word 0, high half), ``minHashesPerWindow`` (u32, word
1), ``concatenated``, ``noncanonical`` and ``preserveCase`` (bits 96-98),
``error`` (f32, word 2) and ``hashSeed`` (u32, word 2, high half, stored as
``seed ^ 42``), and the pointers ``referenceListOld`` (0), ``locusList``
(1), ``alphabet`` (2) and ``referenceList`` (3).  A ``Reference`` has
``length`` (u32, word 0), ``counts32Sorted`` (bit 32), ``length64`` (word 1)
and the pointers ``sequence``, ``quality``, ``name``, ``comment``,
``hashes32``, ``hashes64`` and ``counts32``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class MshRef:
    name: str
    comment: str
    length: int
    hashes: list
    counts: list | None
    counts_sorted: bool


@dataclass
class Msh:
    kmer: int
    window: int
    sketch_size: int
    concatenated: bool
    noncanonical: bool
    preserve_case: bool
    error: float
    seed: int
    alphabet: str
    refs: list = field(default_factory=list)

    @property
    def hash_bits(self) -> int:
        return 64 if len(self.alphabet) ** self.kmer > 2**32 else 32


class _Message:
    def __init__(self, data: bytes):
        (n,) = struct.unpack_from("<I", data, 0)
        sizes = struct.unpack_from(f"<{n + 1}I", data, 4)
        pos = 4 + 4 * (n + 1)
        pos += pos % 8
        self.segs = []
        for size in sizes:
            self.segs.append(data[pos : pos + 8 * size])
            pos += 8 * size

    def word(self, seg: int, at: int) -> int:
        return struct.unpack_from("<Q", self.segs[seg], 8 * at)[0]

    def pointer(self, seg: int, at: int):
        """``(seg, target word, pointer word)`` of the pointer at ``at``,
        through far pointers; None for a null pointer."""
        w = self.word(seg, at)
        if w == 0:
            return None
        if w & 3 != 2:
            off = (w >> 2) & 0x3FFFFFFF
            if off >= 1 << 29:
                off -= 1 << 30
            return seg, at + 1 + off, w
        pad, to = (w >> 3) & 0x1FFFFFFF, w >> 32
        if not (w >> 2) & 1:  # single far: the landing pad is the pointer
            return self.pointer(to, pad)
        far = self.word(to, pad)  # double far: a far pointer to the content, then a tag
        tag = self.word(to, pad + 1)
        return far >> 32, (far >> 3) & 0x1FFFFFFF, tag

    def struct(self, seg: int, at: int):
        p = self.pointer(seg, at)
        if p is None:
            return None
        seg, start, w = p
        return seg, start, (w >> 32) & 0xFFFF, (w >> 48) & 0xFFFF

    def list(self, seg: int, at: int):
        p = self.pointer(seg, at)
        if p is None:
            return None
        seg, start, w = p
        size, count = (w >> 32) & 7, w >> 35
        return seg, start, size, count

    def text(self, seg: int, at: int) -> str:
        lst = self.list(seg, at)
        if lst is None or lst[3] == 0:
            return ""
        seg, start, _, count = lst
        return self.segs[seg][8 * start : 8 * start + count - 1].decode("utf-8", "replace")

    def ints(self, seg: int, at: int, fmt: str) -> list:
        lst = self.list(seg, at)
        if lst is None:
            return []
        seg, start, _, count = lst
        return list(struct.unpack_from(f"<{count}{fmt}", self.segs[seg], 8 * start))


def read_msh(data: bytes) -> Msh:
    """The sketch in the bytes of a ``.msh`` file."""
    m = _Message(data)
    seg, start, dw, pw = m.struct(0, 0)
    data_words = [m.word(seg, start + i) if i < dw else 0 for i in range(3)]

    def u32(slot: int) -> int:
        return (data_words[slot // 2] >> (32 * (slot % 2))) & 0xFFFFFFFF

    def bit(b: int) -> bool:
        return bool((data_words[b // 64] >> (b % 64)) & 1)

    ptrs = start + dw
    out = Msh(kmer=u32(0), window=u32(1), sketch_size=u32(2), concatenated=bit(96),
              noncanonical=bit(97), preserve_case=bit(98),
              error=struct.unpack("<f", struct.pack("<I", u32(4)))[0], seed=u32(5) ^ 42,
              alphabet=(m.text(seg, ptrs + 2) if pw > 2 else "") or "ACGT")
    for slot in (3, 0):  # the new list where it has entries, else the old one
        if slot >= pw:
            continue
        holder = m.struct(seg, ptrs + slot)
        if holder is None or holder[3] == 0:
            continue
        hseg, hstart, hdw, _ = holder
        lst = m.list(hseg, hstart + hdw)
        if lst is None:
            continue
        lseg, tag_at, _, _ = lst
        tag = m.word(lseg, tag_at)
        count, edw, epw = (tag >> 2) & 0x3FFFFFFF, (tag >> 32) & 0xFFFF, (tag >> 48) & 0xFFFF
        refs = []
        for i in range(count):
            base = tag_at + 1 + i * (edw + epw)
            w0 = m.word(lseg, base) if edw > 0 else 0
            length = (m.word(lseg, base + 1) if edw > 1 else 0) or (w0 & 0xFFFFFFFF)
            p = base + edw

            def get(j, fn, *a):
                return fn(lseg, p + j, *a) if j < epw else None

            h64 = get(5, m.ints, "Q") or []
            h32 = get(4, m.ints, "I") or []
            counts = get(6, m.ints, "I") or None
            refs.append(MshRef(name=get(2, m.text) or "", comment=get(3, m.text) or "",
                               length=length, hashes=h64 or h32, counts=counts,
                               counts_sorted=bool((w0 >> 32) & 1)))
        if refs:
            out.refs = refs
            break
    return out
