"""`.msh` sketch file codec — a hand-rolled Cap'n Proto (de)serializer.

The reader reads the file once into one ``np.uint64`` array and decodes it
as columns (:func:`read_columns`): each field of every reference at once, by
array expressions over the words, far pointers included; :func:`read_msh`
builds the JAX package's ``MshFile`` and ``MshReference`` objects from them.
The writer's files are byte for byte the JAX package's: it sizes the message from
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

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from fpmash_tpu_torch.utils.trace import count, trace


#: the list pointers of a ``Reference``: field -> (pointer slot, element size
#: code, element type)
_REF_LISTS = {"name": (2, 2, np.uint8), "comment": (3, 2, np.uint8),
              "hashes32": (4, 4, np.uint32), "hashes64": (5, 5, np.uint64),
              "counts32": (6, 4, np.uint32)}


def _offset(w: np.ndarray) -> np.ndarray:
    """The signed 30-bit offset of pointer words ``w``."""
    off = ((w >> np.uint64(2)) & np.uint64(0x3FFFFFFF)).astype(np.int64)
    return off - ((off >= 1 << 29) << 30)


class _Message:
    """A capnp stream's words, every segment in place in one ``uint64`` array:
    a word's index is its segment's first word plus its offset there, so a
    pointer's target is its own index plus one plus its offset, and only far
    pointers name a segment.  Pointers are followed for whole arrays of
    positions at once."""

    def __init__(self, words: np.ndarray):
        if not len(words):
            raise ValueError("empty capnp stream")
        nseg = int(words[0] & np.uint64(0xFFFFFFFF)) + 1
        sizes = words.view(np.uint32)[1 : 1 + nseg].astype(np.int64)
        first = (nseg + 2) // 2  # the stream header, padded to a word
        self.words = words
        self.base = first + np.cumsum(sizes) - sizes  # each segment's first word
        if first + sizes.sum() > len(words):
            raise ValueError("capnp stream shorter than its segment table")

    def resolve(self, at: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Pointers at word indices ``at`` past their far pointers: each one's
        pointer word, and the index its offset counts from.  A single-far
        pointer's landing pad is a plain pointer counted from the pad; a
        double-far one's pad is a far pointer to the content and a tag."""
        words = self.words
        at = np.array(at, np.int64)
        w = words[at]
        todo = np.flatnonzero((w & np.uint64(3)) == 2)
        while len(todo):
            f = w[todo]
            pad = self._far_target(f)
            double = ((f >> np.uint64(2)) & np.uint64(1)).astype(bool)
            at[todo], w[todo] = pad, words[pad]
            d, pad = todo[double], pad[double]
            if len(d):
                tag = words[pad + 1]
                # the tag reads as a pointer whose target is the content
                at[d] = self._far_target(words[pad]) - 1 - (
                    (tag >> np.uint64(2)) & np.uint64(0x3FFFFFFF)).astype(np.int64)
                w[d] = tag
            todo = todo[~double]
            todo = todo[(w[todo] & np.uint64(3)) == 2]
        return at, w

    def _far_target(self, f: np.ndarray) -> np.ndarray:
        """The word indices that far pointers ``f`` name: segment and offset."""
        return self.base[(f >> np.uint64(32)).astype(np.int64)] + (
            (f >> np.uint64(3)) & np.uint64(0x1FFFFFFF)).astype(np.int64)

    def lists(self, at: np.ndarray, esize: int) -> tuple[np.ndarray, np.ndarray]:
        """The lists of element size code ``esize`` (not composite) whose
        pointers sit at ``at``: each one's first word and element count, both
        0 for a null pointer."""
        at, w = self.resolve(at)
        live = w != 0
        if ((w[live] & np.uint64(3)) != 1).any():
            raise ValueError("expected list pointer")
        if (((w[live] >> np.uint64(32)) & np.uint64(7)) != esize).any():
            raise ValueError(f"expected lists of element size {esize}")
        start = np.where(live, at + 1 + _offset(w), 0)
        return start, np.where(live, w >> np.uint64(35), 0).astype(np.int64)

    def composite(self, at: int):
        """The composite list whose pointer sits at ``at``: (first element's
        word, element count, data words, pointer words), or None if null."""
        (at,), (w,) = self.resolve([at])
        if w == 0:
            return None
        if int(w) & 3 != 1:
            raise ValueError("expected list pointer")
        if int(w) >> 32 & 7 != 7:
            raise ValueError("expected a composite list")
        start = int(at + 1 + _offset(w))
        tag = int(self.words[start])
        return start + 1, (tag >> 2) & 0x3FFFFFFF, (tag >> 32) & 0xFFFF, (tag >> 48) & 0xFFFF

    def struct(self, at: int):
        """The struct whose pointer sits at ``at``: (first data word, data
        words, pointer words), or None if null."""
        (at,), (w,) = self.resolve([at])
        if w == 0:
            return None
        if int(w) & 3 != 0:
            raise ValueError(f"expected struct pointer, got kind {int(w) & 3}")
        return int(at + 1 + _offset(w)), (int(w) >> 32) & 0xFFFF, (int(w) >> 48) & 0xFFFF

    def text(self, first: int, nbytes: int) -> str:
        """The text of ``nbytes`` bytes (its NUL included) from byte ``first``."""
        raw = self.words.view(np.uint8)[first : first + nbytes]
        return raw[:-1].tobytes().decode("utf-8", "replace") if nbytes else ""


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


@dataclass
class MshColumns:
    """A ``.msh`` file decoded as columns: the header's parameters and loci
    (``header``, an :class:`MshFile` without references), the file's words,
    and for every reference its length, its ``counts32Sorted`` bit, and where
    each of its lists lies (``lists``: field name -> its first element in the
    words viewed as its element type, bytes for a text, and its count; a
    field the file's ``Reference`` structs have no pointer for is left out, a
    null list reads 0 and 0).  Nothing here is a Python
    object a reference: texts decode on demand (:meth:`text`), and
    :meth:`reference` builds one :class:`MshReference`, counted in
    ``objects``."""

    header: MshFile
    message: _Message
    lengths: np.ndarray  # uint64
    counts32_sorted: np.ndarray  # bool
    lists: dict
    objects: int = 0

    @property
    def words(self) -> np.ndarray:
        """The file as ``uint64`` words, the stream header first."""
        return self.message.words

    def __len__(self) -> int:
        return len(self.lengths)

    def text(self, name: str, i: int) -> str:
        """Reference ``i``'s ``name`` or ``comment``."""
        if name not in self.lists:
            return ""
        first, nbytes = self.lists[name]
        return self.message.text(int(first[i]), int(nbytes[i]))

    def elements(self, name: str) -> tuple[np.ndarray, np.ndarray, type]:
        """Where each reference's list ``name`` lies in the file's words
        viewed as its element type: first element, count, and the type."""
        dtype = _REF_LISTS[name][2]
        if name not in self.lists:
            return np.zeros(len(self), np.int64), np.zeros(len(self), np.int64), dtype
        return *self.lists[name], dtype

    def values(self, name: str, i: int) -> np.ndarray | None:
        """A copy of reference ``i``'s list ``name`` (None where the file's
        structs have no such pointer)."""
        if name not in self.lists:
            return None
        first, n = (int(a[i]) for a in self.lists[name])
        return self.words.view(_REF_LISTS[name][2])[first : first + n].copy()

    def reference(self, i: int) -> MshReference:
        self.objects += 1
        counts = self.values("counts32", i)
        return MshReference(
            name=self.text("name", i), comment=self.text("comment", i),
            length=int(self.lengths[i]), hashes32=self.values("hashes32", i),
            hashes64=self.values("hashes64", i),
            counts32=counts if counts is not None and len(counts) else None,
            counts32_sorted=bool(self.counts32_sorted[i]),
        )


def _read_words(path: str) -> np.ndarray:
    """The file at ``path`` read once into a ``uint64`` array of its own (a
    last partial word padded with zeros)."""
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        words = np.zeros(-(-size // 8), np.uint64)
        view = memoryview(words.view(np.uint8))[:size]
        got = 0
        while got < size:
            n = fh.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: file shrank while read")
            got += n
    return words


def read_columns(path: str) -> MshColumns:
    """The ``.msh`` at ``path`` as :class:`MshColumns`: every field of the
    reference list decoded for all references at once (span ``msh-read``)."""
    with trace("msh-read", file=path):
        msg = _Message(_read_words(path))
        words = msg.words
        root = msg.struct(int(msg.base[0]))
        if root is None:
            raise ValueError("empty capnp message")
        start, dw, pw = root

        def data_u32(slot):
            if slot // 2 >= dw:
                return 0
            return (int(words[start + slot // 2]) >> (32 * (slot % 2))) & 0xFFFFFFFF

        def data_bit(bit):
            return bit // 64 < dw and bool((int(words[start + bit // 64]) >> (bit % 64)) & 1)

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

        def reflist(ptr_slot):
            """The composite list held by the struct at pointer ``ptr_slot``."""
            st = msg.struct(pbase + ptr_slot) if ptr_slot < pw else None
            if st is None or not st[2]:
                return None
            return msg.composite(st[0] + st[1])

        # Prefer the new slot when it has content (Sketch.cpp:446)
        refs = reflist(3)
        if refs is None or not refs[1]:
            refs = reflist(0)
        estart, n, edw, epw = refs if refs is not None else (0, 0, 0, 0)
        base = estart + (edw + epw) * np.arange(n, dtype=np.int64)
        data = words[base] if edw > 0 else np.zeros(n, np.uint64)
        lengths = data & np.uint64(0xFFFFFFFF)
        counts32_sorted = ((data >> np.uint64(32)) & np.uint64(1)).astype(bool)
        if edw > 1:
            length64 = words[base + 1]
            lengths = np.where(length64 != 0, length64, lengths)
        lists = {}
        for name, (slot, esize, dtype) in _REF_LISTS.items():
            if slot < epw:
                start, n = msg.lists(base + edw + slot, esize)
                lists[name] = (start * (8 // np.dtype(dtype).itemsize), n)

        if pw > 2:
            at, nbytes = msg.lists([pbase + 2], 2)
            out.alphabet = msg.text(8 * int(at[0]), int(nbytes[0])) or "ACGT"

        # locusList (ptr 1) — legacy windowed mode; Locus: 3 data words, 0 ptrs
        st = msg.struct(pbase + 1) if pw > 1 else None
        loci = msg.composite(st[0] + st[1]) if st is not None and st[2] else None
        if loci is not None:
            lstart, nloci, ldw, lpw = loci
            rows = lstart + (ldw + lpw) * np.arange(nloci, dtype=np.int64)
            w0 = words[rows]
            hash64 = words[rows + 2] if ldw > 2 else np.zeros(nloci, np.uint64)
            out.loci = list(zip((w0 & np.uint64(0xFFFFFFFF)).tolist(),
                                (w0 >> np.uint64(32)).tolist(), hash64.tolist()))
        return MshColumns(out, msg, lengths, counts32_sorted, lists)


def read_msh(path: str) -> MshFile:
    """The ``.msh`` at ``path`` with one :class:`MshReference` a reference,
    built from :func:`read_columns`."""
    db = read_columns(path)
    out = db.header
    out.references = [db.reference(i) for i in range(len(db))]
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
