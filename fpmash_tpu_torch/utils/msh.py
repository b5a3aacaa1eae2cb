"""`.msh` sketch file codec — a hand-rolled Cap'n Proto (de)serializer.

The reader is a copy of :mod:`fpmash_tpu.utils.msh`'s.  The writer is not,
but its files are byte for byte the JAX package's: it sizes the message from
the references, then fills one ``np.uint64`` buffer whose first word is the
stream header, copying every hash, count, text and locus list in whole arrays
and setting every list pointer in one array expression, so the file is the
buffer's bytes.

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

import numpy as np

from fpmash_tpu_torch.utils.trace import count, trace


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


class _Layout:
    """Where each list of a single-segment message goes, before any word is
    set: the message's size in words, and each list's pointer and payload."""

    def __init__(self, size: int):
        self.size = size
        self.ptrs: list[tuple[int, int, int, int]] = []  # (at, target, esize, count)
        self.fills: list[tuple[int, np.ndarray]] = []  # (target, payload)
        self.bulk = 0  # words of the payloads

    def put(self, at: int, esize: int, count: int, nwords: int, payload=None):
        """A list pointer at word ``at`` to ``nwords`` new words."""
        self.ptrs.append((at, self.size, esize, count))
        if payload is not None:
            self.fills.append((self.size, payload))
            self.bulk += nwords
        self.size += nwords

    def put_text(self, at: int, text: str):
        if text is None:
            return
        raw = np.frombuffer(text.encode("utf-8") + b"\0", np.uint8)
        self.put(at, 2, len(raw), (len(raw) + 7) // 8, raw)

    def put_u32_list(self, at: int, values):
        values = np.asarray(values, np.uint32)
        self.put(at, 4, len(values), (len(values) + 1) // 2, values)

    def put_u64_list(self, at: int, values):
        values = np.asarray(values, np.uint64)
        self.put(at, 5, len(values), len(values), values)


def _struct_ptr(at: int, target: int, dw: int, pw: int) -> int:
    return ((target - at - 1) << 2) | (dw << 32) | (pw << 48)


def write_msh(path: str, m: MshFile) -> None:
    """Write ``m`` to ``path`` in three traced phases: the message's layout
    (``msh-words``, counters ``words`` and ``bulk_words``, the words filled by
    whole-array copies), the stream header and the buffer's bytes
    (``msh-pack``) and the file (``msh-file``)."""
    with trace("msh-words", references=len(m.references)):
        buf, bulk = _message(m)
        count("words", len(buf) - 1)
        count("bulk_words", bulk)
    with trace("msh-pack", words=len(buf) - 1):
        buf[0] = (len(buf) - 1) << 32  # segment count - 1 = 0, then the size in words
        data = buf.view(np.uint8)
    with trace("msh-file", bytes=data.nbytes):
        with open(path, "wb") as fh:
            fh.write(data)


def _message(m: MshFile) -> tuple[np.ndarray, int]:
    """``m``'s single-segment message as ``uint64`` words after one word left
    for the stream header, and the number of words copied in whole arrays."""
    refs = m.references
    n = len(refs)
    edw, epw = 2, 7  # Reference: data words, pointers
    stride = edw + epw
    # root pointer, root struct (3 data, 4 pointers), ReferenceList (0 data, 1
    # pointer), the references' tag and elements
    root, rl, tag_pos = 1, 8, 9
    lay = _Layout(tag_pos)
    # composite list: word count in the pointer, element count in the tag
    lay.put(rl, 7, n * stride, 1 + n * stride)
    for i, ref in enumerate(refs):
        pb = tag_pos + 1 + i * stride + edw
        lay.put_text(pb + 2, ref.name)
        lay.put_text(pb + 3, ref.comment)
        if ref.hashes32 is not None and len(ref.hashes32):
            lay.put_u32_list(pb + 4, ref.hashes32)
        if ref.hashes64 is not None and len(ref.hashes64):
            lay.put_u64_list(pb + 5, ref.hashes64)
        if ref.counts32 is not None and len(ref.counts32):
            lay.put_u32_list(pb + 6, ref.counts32)
    pbase = root + 3
    lay.put_text(pbase + 2, m.alphabet)
    # locusList (ptr 1): always present (Sketch.cpp:606 initLocusList);
    # Locus: 3 data words, 0 pointers
    ll = lay.size
    lay.size += 1
    nloci = len(m.loci)
    if nloci:
        ltag = lay.size
        lay.put(ll, 7, nloci * 3, 1 + nloci * 3)

    buf = np.zeros(1 + lay.size, np.uint64)
    w = buf[1:]
    w32 = w.view(np.uint32)
    w[0] = _struct_ptr(0, root, 3, 4)
    w32[2 * root : 2 * root + 6] = [
        v & 0xFFFFFFFF for v in (
            m.kmer_size, m.window_size, m.min_hashes_per_window,
            # bits 96-98: concatenated, noncanonical, preserveCase
            bool(m.concatenated) | bool(m.noncanonical) << 1 | bool(m.preserve_case) << 2,
            struct.unpack("<I", struct.pack("<f", m.error))[0],
            m.hash_seed ^ 42,  # default-42 XOR
        )
    ]
    # referenceListOld (ptr 0) when seed==42, else referenceList (ptr 3)
    # (Sketch.cpp:549)
    list_slot = 0 if m.hash_seed == 42 else 3
    w[pbase + list_slot] = _struct_ptr(pbase + list_slot, rl, 0, 1)
    w[pbase + 1] = _struct_ptr(pbase + 1, ll, 0, 1)
    w[tag_pos] = ((n & 0x3FFFFFFF) << 2) | (edw << 32) | (epw << 48)
    if n:
        # The reference writer sets only length64, leaving the u32 length
        # zero (writeToCapnp sets setLength64 only) — mirrored here.
        elems = w[tag_pos + 1 : tag_pos + 1 + n * stride].reshape(n, stride)
        elems[:, 0] = np.array([r.counts32_sorted for r in refs], np.uint64) << np.uint64(32)
        elems[:, 1] = np.array([r.length for r in refs], np.uint64)

    at, target, esize, cnt = np.array(lay.ptrs, np.uint64).T  # every target after its pointer
    w[at] = 1 | ((target - at - 1) & 0x3FFFFFFF) << 2 | esize << 32 | cnt << 35
    views = {1: w.view(np.uint8), 4: w32, 8: w}  # by element size
    for start, payload in lay.fills:  # the rest of a list's last word stays zero
        first = start * 8 // payload.itemsize
        views[payload.itemsize][first : first + len(payload)] = payload
    bulk = lay.bulk
    if nloci:
        loci = np.array(m.loci, np.uint64).reshape(nloci, 3)
        rows = w[ltag + 1 : ltag + 1 + 3 * nloci].reshape(nloci, 3)
        rows[:, 0] = (loci[:, 0] & np.uint64(0xFFFFFFFF)) | (
            (loci[:, 1] & np.uint64(0xFFFFFFFF)) << np.uint64(32))
        rows[:, 2] = loci[:, 2]
        w[ltag] = ((nloci & 0x3FFFFFFF) << 2) | (3 << 32)
        bulk += 3 * nloci
    return buf, bulk
