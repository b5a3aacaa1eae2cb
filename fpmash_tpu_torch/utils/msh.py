"""`.msh` sketch file codec — a hand-rolled Cap'n Proto (de)serializer.

A copy of :mod:`fpmash_tpu.utils.msh`; the port writes byte-identical files.

The reference persists sketches via Cap'n Proto using the small fixed schema
``mash/src/mash/capnp/MinHash.capnp`` (no pycapnp in this environment, and
the schema never changes, so the wire format is implemented directly).

Wire format implemented per the Cap'n Proto encoding spec:

* stream framing: u32 ``segment_count-1``, u32 sizes (words), pad to 8B;
* struct pointers ``(offset:30s, data_words:16, ptr_words:16)``, list
  pointers ``(offset:30s, elem_size:3, count:29)``, far pointers for
  multi-segment files (the reference's MallocMessageBuilder emits several
  segments; our writer emits one);
* default-value XOR on primitives — notably ``hashSeed @10 :UInt32 = 42``
  stores ``seed ^ 42`` (so the ubiquitous default seed encodes as 0).

Field layout (derived from capnp's ordinal allocation; verified against the
reference fixture bytes):

``MinHash`` — 3 data words, 4 pointers:
  w0: kmerSize u32@0, windowSize u32@1; w1: minHashesPerWindow u32@2,
  concatenated bit@96, noncanonical bit@97, preserveCase bit@98;
  w2: error f32@4, hashSeed u32@5 (xor 42);
  ptrs: 0 referenceListOld, 1 locusList, 2 alphabet (Text), 3 referenceList.
  Seed==42 selects the legacy ``referenceListOld`` slot on write
  (Sketch.cpp:549); readers prefer ``referenceList`` when non-empty
  (Sketch.cpp:446,1084).

``Reference`` — 2 data words, 7 pointers:
  w0: length u32@0, counts32Sorted bit@32; w1: length64 u64;
  ptrs: 0 sequence, 1 quality, 2 name, 3 comment, 4 hashes32, 5 hashes64,
  6 counts32.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from fpmash_tpu_torch.utils.trace import trace


def _ptr_parts(word: int):
    kind = word & 3
    offset = (word >> 2) & 0x3FFFFFFF
    if offset >= 1 << 29:
        offset -= 1 << 30
    return kind, offset


class _Reader:
    """Minimal capnp message reader over a list of segments (bytes)."""

    def __init__(self, data: bytes):
        nseg = struct.unpack_from("<I", data, 0)[0] + 1
        sizes = struct.unpack_from(f"<{nseg}I", data, 4)
        table = 4 + 4 * nseg
        table += (-table) % 8
        self.segments = []
        pos = table
        for s in sizes:
            self.segments.append(data[pos : pos + 8 * s])
            pos += 8 * s

    def word(self, seg: int, idx: int) -> int:
        return struct.unpack_from("<Q", self.segments[seg], idx * 8)[0]

    def _resolve(self, seg: int, idx: int):
        """Follow far pointers; return (seg, idx, pointer_word)."""
        w = self.word(seg, idx)
        kind = w & 3
        if kind != 2:
            return seg, idx, w
        double_far = (w >> 2) & 1
        pad_off = w >> 3 & 0x1FFFFFFF
        target_seg = w >> 32
        if not double_far:
            return self._resolve(target_seg, pad_off)
        # double-far: landing pad is a far ptr to content + a tag word
        far2 = self.word(target_seg, pad_off)
        content_seg = far2 >> 32
        content_off = far2 >> 3 & 0x1FFFFFFF
        tag = self.word(target_seg, pad_off + 1)
        # tag looks like an intra-segment pointer with offset 0
        return content_seg, content_off - (((tag >> 2) & 0x3FFFFFFF) + 1), tag

    def struct_at(self, seg: int, idx: int):
        """Return (seg, data_start, data_words, ptr_words) or None."""
        seg, idx, w = self._resolve(seg, idx)
        if w == 0:
            return None
        kind, offset = _ptr_parts(w)
        if (w & 3) == 2:  # far pointer resolved to content directly
            start = idx
        else:
            assert kind == 0, f"expected struct pointer, got kind {kind}"
            start = idx + 1 + offset
        data_words = (w >> 32) & 0xFFFF
        ptr_words = (w >> 48) & 0xFFFF
        return seg, start, data_words, ptr_words

    def list_at(self, seg: int, idx: int):
        """Return (seg, start_word, elem_size_code, count, tag) or None."""
        seg, idx, w = self._resolve(seg, idx)
        if w == 0:
            return None
        kind, offset = _ptr_parts(w)
        assert kind == 1, f"expected list pointer, got kind {kind}"
        start = idx + 1 + offset
        esize = (w >> 32) & 7
        count = w >> 35
        tag = None
        if esize == 7:
            tag = self.word(seg, start)
            count = (tag >> 2) & 0x3FFFFFFF  # element count from tag
            start += 1
        return seg, start, esize, count, tag

    def text_at(self, seg: int, idx: int) -> str:
        lst = self.list_at(seg, idx)
        if lst is None:
            return ""
        seg, start, esize, count, _ = lst
        assert esize == 2
        raw = self.segments[seg][start * 8 : start * 8 + count]
        return raw[:-1].decode("utf-8", "replace") if count else ""

    def u32_list_at(self, seg: int, idx: int):
        import numpy as np

        lst = self.list_at(seg, idx)
        if lst is None:
            return np.zeros(0, np.uint32)
        seg, start, esize, count, _ = lst
        assert esize == 4
        return np.frombuffer(
            self.segments[seg], np.uint32, count=count, offset=start * 8
        ).copy()

    def u64_list_at(self, seg: int, idx: int):
        import numpy as np

        lst = self.list_at(seg, idx)
        if lst is None:
            return np.zeros(0, np.uint64)
        seg, start, esize, count, _ = lst
        assert esize == 5
        return np.frombuffer(
            self.segments[seg], np.uint64, count=count, offset=start * 8
        ).copy()


@dataclass
class MshReference:
    name: str = ""
    comment: str = ""
    length: int = 0
    hashes32: "object" = None  # np.ndarray u32
    hashes64: "object" = None  # np.ndarray u64
    counts32: "object" = None  # np.ndarray u32 or None
    counts32_sorted: bool = False


@dataclass
class MshFile:
    kmer_size: int = 21
    window_size: int = 0
    min_hashes_per_window: int = 1000
    concatenated: bool = True
    error: float = 0.0
    noncanonical: bool = False
    alphabet: str = "ACGT"
    preserve_case: bool = False
    hash_seed: int = 42
    references: list = field(default_factory=list)
    loci: list = field(default_factory=list)  # (sequence, position, hash64)

    @property
    def use64(self) -> bool:
        """32/64-bit selection rule (Sketch.cpp:1288)."""
        return len(self.alphabet) ** self.kmer_size > 2**32


def read_msh(path: str) -> MshFile:
    with open(path, "rb") as fh:
        data = fh.read()
    r = _Reader(data)
    root = r.struct_at(0, 0)
    assert root is not None, "empty capnp message"
    seg, start, dw, pw = root

    def data_u32(slot):
        if slot // 2 >= dw:
            return 0
        w = r.word(seg, start + slot // 2)
        return (w >> (32 * (slot % 2))) & 0xFFFFFFFF

    def data_bit(bit):
        if bit // 64 >= dw:
            return False
        return bool((r.word(seg, start + bit // 64) >> (bit % 64)) & 1)

    out = MshFile()
    out.kmer_size = data_u32(0)
    out.window_size = data_u32(1)
    out.min_hashes_per_window = data_u32(2)
    out.concatenated = data_bit(96)
    out.noncanonical = data_bit(97)
    out.preserve_case = data_bit(98)
    out.error = struct.unpack("<f", struct.pack("<I", data_u32(4)))[0]
    out.hash_seed = data_u32(5) ^ 42  # default-42 XOR encoding

    pbase = start + dw

    def read_reflist(ptr_slot):
        st = r.struct_at(seg, pbase + ptr_slot) if ptr_slot < pw else None
        if st is None:
            return []
        lseg, lstart, ldw, lpw = st
        lst = r.list_at(lseg, lstart + ldw + 0) if lpw else None
        if lst is None:
            return []
        eseg, estart, esize, count, tag = lst
        assert esize == 7, "references must be a composite list"
        edw = (tag >> 32) & 0xFFFF
        epw = (tag >> 48) & 0xFFFF
        stride = edw + epw
        refs = []
        for i in range(count):
            base = estart + i * stride
            ref = MshReference()
            w0 = r.word(eseg, base) if edw > 0 else 0
            ref.length = w0 & 0xFFFFFFFF
            ref.counts32_sorted = bool((w0 >> 32) & 1)
            if edw > 1:
                length64 = r.word(eseg, base + 1)
                if length64:
                    ref.length = length64
            pb = base + edw
            if epw > 2:
                ref.name = r.text_at(eseg, pb + 2)
            if epw > 3:
                ref.comment = r.text_at(eseg, pb + 3)
            if epw > 4:
                ref.hashes32 = r.u32_list_at(eseg, pb + 4)
            if epw > 5:
                ref.hashes64 = r.u64_list_at(eseg, pb + 5)
            if epw > 6:
                counts = r.u32_list_at(eseg, pb + 6)
                ref.counts32 = counts if len(counts) else None
            refs.append(ref)
        return refs

    # Prefer the new slot when it has content (Sketch.cpp:446)
    refs = read_reflist(3)
    if not refs:
        refs = read_reflist(0)
    out.references = refs

    if pw > 2:
        out.alphabet = r.text_at(seg, pbase + 2) or "ACGT"

    # locusList (ptr 1) — legacy windowed mode; Locus: 3 data words, 0 ptrs
    st = r.struct_at(seg, pbase + 1) if pw > 1 else None
    if st is not None:
        lseg, lstart, ldw, lpw = st
        lst = r.list_at(lseg, lstart + ldw) if lpw else None
        if lst is not None:
            eseg, estart, esize, count, tag = lst
            edw = (tag >> 32) & 0xFFFF
            epw = (tag >> 48) & 0xFFFF
            stride = edw + epw
            for i in range(count):
                base = estart + i * stride
                w0 = r.word(eseg, base)
                sequence = w0 & 0xFFFFFFFF
                position = w0 >> 32
                hash64 = r.word(eseg, base + 2) if edw > 2 else 0
                out.loci.append((sequence, position, hash64))
    return out


class _Writer:
    """Single-segment capnp message builder."""

    def __init__(self):
        self.words: list[int] = [0]  # root pointer placeholder

    def alloc(self, n: int) -> int:
        start = len(self.words)
        self.words.extend([0] * n)
        return start

    def put_struct_ptr(self, at: int, target: int, dw: int, pw: int):
        offset = target - at - 1
        self.words[at] = (offset << 2) | (dw << 32) | (pw << 48)

    def put_list_ptr(self, at: int, target: int, esize: int, count: int):
        offset = target - at - 1
        self.words[at] = 1 | ((offset & 0x3FFFFFFF) << 2) | (esize << 32) | (count << 35)

    def put_text(self, at: int, text: str):
        if text is None:
            return
        raw = text.encode("utf-8") + b"\0"
        nwords = (len(raw) + 7) // 8
        start = self.alloc(nwords)
        self.put_list_ptr(at, start, 2, len(raw))
        padded = raw + b"\0" * (nwords * 8 - len(raw))
        for i in range(nwords):
            self.words[start + i] = struct.unpack_from("<Q", padded, i * 8)[0]

    def put_u32_list(self, at: int, values):
        import numpy as np

        values = np.asarray(values, np.uint32)
        nwords = (len(values) + 1) // 2
        start = self.alloc(nwords)
        self.put_list_ptr(at, start, 4, len(values))
        raw = values.tobytes() + b"\0" * (nwords * 8 - len(values) * 4)
        for i in range(nwords):
            self.words[start + i] = struct.unpack_from("<Q", raw, i * 8)[0]

    def put_u64_list(self, at: int, values):
        import numpy as np

        values = np.asarray(values, np.uint64)
        start = self.alloc(len(values))
        self.put_list_ptr(at, start, 5, len(values))
        for i, v in enumerate(values):
            self.words[start + i] = int(v)

    def tobytes(self) -> bytes:
        n = len(self.words)
        pad = n % 2  # segment table is 8 bytes (count+1 size), total already 8-aligned
        header = struct.pack("<II", 0, n)
        body = b"".join(struct.pack("<Q", w) for w in self.words)
        return header + body


def write_msh(path: str, m: MshFile) -> None:
    """Write ``m`` to ``path`` in three traced phases: the message's words
    (``msh-words``), their bytes (``msh-pack``) and the file (``msh-file``)."""
    with trace("msh-words", references=len(m.references)):
        w = _message(m)
    with trace("msh-pack", words=len(w.words)):
        data = w.tobytes()
    with trace("msh-file", bytes=len(data)):
        with open(path, "wb") as fh:
            fh.write(data)


def _message(m: MshFile) -> _Writer:
    """The words of ``m``'s single-segment message."""
    w = _Writer()
    root = w.alloc(3 + 4)
    w.put_struct_ptr(0, root, 3, 4)
    pbase = root + 3

    def set_u32(slot, val):
        word = root + slot // 2
        sh = 32 * (slot % 2)
        w.words[word] |= (val & 0xFFFFFFFF) << sh

    def set_bit(bit, val):
        if val:
            w.words[root + bit // 64] |= 1 << (bit % 64)

    set_u32(0, m.kmer_size)
    set_u32(1, m.window_size)
    set_u32(2, m.min_hashes_per_window)
    set_bit(96, m.concatenated)
    set_bit(97, m.noncanonical)
    set_bit(98, m.preserve_case)
    set_u32(4, struct.unpack("<I", struct.pack("<f", m.error))[0])
    set_u32(5, m.hash_seed ^ 42)

    # referenceListOld (ptr 0) when seed==42, else referenceList (ptr 3)
    # (Sketch.cpp:549)
    list_slot = 0 if m.hash_seed == 42 else 3
    rl = w.alloc(1)  # ReferenceList struct: 0 data, 1 ptr
    w.put_struct_ptr(pbase + list_slot, rl, 0, 1)

    refs = m.references
    edw, epw = 2, 7
    stride = edw + epw
    tag_pos = w.alloc(1 + len(refs) * stride)
    # composite list: count word-count in ptr, element count in tag
    w.put_list_ptr(rl, tag_pos, 7, len(refs) * stride)
    w.words[tag_pos] = ((len(refs) & 0x3FFFFFFF) << 2) | (edw << 32) | (epw << 48)

    for i, ref in enumerate(refs):
        base = tag_pos + 1 + i * stride
        # The reference writer sets only length64, leaving the u32 length
        # zero (writeToCapnp sets setLength64 only) — mirrored here.
        w.words[base] = (1 << 32) if ref.counts32_sorted else 0
        w.words[base + 1] = ref.length
        pb = base + edw
        w.put_text(pb + 2, ref.name)
        w.put_text(pb + 3, ref.comment)
        if ref.hashes32 is not None and len(ref.hashes32):
            w.put_u32_list(pb + 4, ref.hashes32)
        if ref.hashes64 is not None and len(ref.hashes64):
            w.put_u64_list(pb + 5, ref.hashes64)
        if ref.counts32 is not None and len(ref.counts32):
            w.put_u32_list(pb + 6, ref.counts32)

    # alphabet text (ptr 2)
    w.put_text(pbase + 2, m.alphabet)

    # locusList (ptr 1): always present (Sketch.cpp:606 initLocusList)
    ll = w.alloc(1)
    w.put_struct_ptr(pbase + 1, ll, 0, 1)
    if m.loci:
        ltag = w.alloc(1 + len(m.loci) * 3)
        w.put_list_ptr(ll, ltag, 7, len(m.loci) * 3)
        w.words[ltag] = ((len(m.loci) & 0x3FFFFFFF) << 2) | (3 << 32) | (0 << 48)
        for i, (sequence, position, hash64) in enumerate(m.loci):
            base = ltag + 1 + i * 3
            w.words[base] = (sequence & 0xFFFFFFFF) | ((position & 0xFFFFFFFF) << 32)
            w.words[base + 2] = hash64
    return w
