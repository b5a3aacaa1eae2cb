"""Sketch engine: the MinHash container and its fingerprint construction paths.

Port of the fingerprint half of :mod:`fpmash_tpu.models.sketch`
(``mash/src/mash/Sketch.{h,cpp}``).  A sketch is a host-side list of
references whose hash arrays are computed on the chosen device:

* ``sketch -fp`` (:meth:`Sketch.init_from_fingerprints`, Sketch.cpp:56-151):
  every fingerprint line is one MurmurHash3 of its u64 length vector, kept
  in file order, unsorted, with no bottom-k — all lines of all files are
  hashed in one batch (``ops/murmur3.py``).
* ``sketch --direct-fp`` (:meth:`Sketch.init_from_reads_fingerprint`): reads
  -> shift windows -> factor lengths of any of the ten families -> hash,
  without writing the fingerprint text: CFL in one kernel
  (``ops/fused_cuda.py``), the other families in two (``ops/icfl_cuda.py``).

Persistence is the byte-compatible ``.msh`` codec of ``utils/msh.py``.
The sketch is the state this system carries between commands, as weights
are a model's; :func:`sketch_from_arrays` builds one from plain fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Mapping

import numpy as np
import torch

from fpmash_tpu_torch.utils.trace import trace

#: global fingerprint line cap across all files (Sketch.cpp:37,82)
LIMIT_READ_FINGERPRINT = 1_000_000


@dataclass
class SketchParams:
    """Sketch::Parameters (Sketch.h:81-120) with the same defaults
    (Command.cpp:183-228): k=21, s=1000, seed=42, canonical DNA.  The same
    fields as the JAX package's, so either converts to the other."""

    kmer_size: int = 21
    sketch_size: int = 1000  # minHashesPerWindow
    seed: int = 42
    noncanonical: bool = False
    preserve_case: bool = False
    alphabet: str = "ACGT"
    concatenated: bool = True
    error: float = 0.0
    window_size: int = 0
    reads: bool = False
    min_cov: int = 1
    target_cov: float = 0.0
    bloom_bytes: int = 0
    counts: bool = False
    fingerprint: bool = False
    windowed: bool = False

    @property
    def use64(self) -> bool:
        """64-bit hashes iff alphabet^k exceeds 2^32 (Sketch.cpp:1288)."""
        return len(self.alphabet) ** self.kmer_size > 2**32

    @property
    def kmer_space(self) -> float:
        """alphabetSize^kmerSize (Sketch.cpp:660)."""
        return float(len(self.alphabet)) ** self.kmer_size

    def for_fingerprint(self) -> "SketchParams":
        """Fingerprint-mode overrides (sketchParameterSetup.cpp:78-84):
        k=1, noncanonical, alphabet '0123456789' (=> 32-bit hashes)."""
        return replace(
            self, kmer_size=1, noncanonical=True, alphabet="0123456789", fingerprint=True
        )


@dataclass
class Reference:
    """One sketched reference (Sketch.h:177-186)."""

    name: str = ""
    comment: str = ""
    length: int = 0
    hashes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))


class Sketch:
    """Container of sketched references + parameters."""

    def __init__(self, params: SketchParams | None = None):
        self.params = params or SketchParams()
        self.references: list[Reference] = []
        self._index_by_id: dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # fingerprint path
    # ------------------------------------------------------------------ #

    def init_from_fingerprints(
        self, files: list[str], bug_compat_length: bool = True, *, device
    ) -> None:
        """Load fingerprint ``.txt`` files (Sketch.cpp:56-151).

        Line format ``ID n1 n2 ...``; consecutive lines with equal ID are
        grouped into one reference (Sketch.cpp:103-129 — non-adjacent
        duplicate IDs create separate references); each line becomes one
        hash of its uint64 vector, appended in file order (unsorted, no
        bottom-k).  A global cap of 1e6 lines applies across all files.

        ``bug_compat_length=True`` reproduces the reference's length
        accounting where the first line of each reference is counted twice
        (Sketch.cpp:117,134).
        """
        p = self.params
        line_budget = LIMIT_READ_FINGERPRINT

        groups: list[tuple[str, list[list[int]]]] = []
        last_id = None  # NOTE: carries across files, like the reference
        for path in files:
            with open(path) as fh:
                for line in fh:
                    if line_budget <= 0:
                        break
                    line_budget -= 1
                    parts = line.split()
                    if not parts:
                        continue
                    rid = parts[0]
                    # mirror `ss >> uint64_t`: stop at first non-integer token
                    vec = []
                    for tok in parts[1:]:
                        try:
                            vec.append(int(tok))
                        except ValueError:
                            break
                    if rid != last_id:
                        groups.append((rid, []))
                        last_id = rid
                    groups[-1][1].append(vec)

        all_vecs = [v for _, vecs in groups for v in vecs]
        with trace("fingerprint-hash", lines=len(all_vecs)):
            hashes = _hash_u64_vectors(all_vecs, p.seed, p.use64, device)

        pos = 0
        for rid, vecs in groups:
            sizes = [len(v) for v in vecs]
            length = sum(sizes) + (sizes[0] if bug_compat_length and sizes else 0)
            self.references.append(
                Reference(
                    name=rid,
                    comment=f"FingerPrint : {rid}",
                    length=length,
                    hashes=hashes[pos : pos + len(vecs)],
                )
            )
            pos += len(vecs)
        self._create_index()

    def init_from_reads_fingerprint(
        self,
        reads,
        factorization: str = "CFL",
        shift: bool = True,
        bug_compat_length: bool = True,
        *,
        device,
    ) -> None:
        """Reads -> shift windows -> factorization -> hash -> references,
        without writing fingerprint text (``sketch --direct-fp``).

        Produces the same sketch as the lyn2vec pipeline to a ``.txt``
        followed by :meth:`init_from_fingerprints`, for any of the ten
        factorization families.  ``reads`` yields ``(id, SEQ)``.  Each read
        is shipped to the device once, upper-cased and followed by its first
        99 characters, and every window is named by its start and length in
        that stream: a read of ``n >= 100`` characters gives ``n`` cyclic
        windows of 100, a shorter read (or any read with ``shift=False``)
        one window of itself.  CFL windows go through kernel K1
        (``ops/fused_cuda.py``); the other families through ``factor_words``
        then ``hash_words`` (``ops/icfl_cuda.py``), with the scalar model for
        the rows ``models/fingerprint.py`` routes there.
        """
        from fpmash_tpu_torch.models.fingerprint import window_stream
        from fpmash_tpu_torch.ops.factorize import plan
        from fpmash_tpu_torch.ops.fused_cuda import fingerprint_hashes

        plan(factorization)  # an unknown family fails before any work
        p = self.params
        reads = list(reads)
        flat, starts, lengths, counts = window_stream([s.upper() for _, s in reads], shift)
        # the global line cap cuts the windows of the last reads
        before = np.cumsum(counts) - counts
        takes = np.clip(LIMIT_READ_FINGERPRINT - before, 0, counts)
        n_windows = int(takes.sum())
        starts, lengths = starts[:n_windows], lengths[:n_windows]

        if factorization == "CFL":
            with trace("factorize+hash", windows=n_windows):
                h1, _, count = fingerprint_hashes(
                    torch.from_numpy(flat).to(device),
                    torch.from_numpy(starts).to(device),
                    torch.from_numpy(lengths).to(device),
                    p.seed,
                )
                h1 = h1.cpu().numpy().view(np.uint64)
                count = count.cpu().numpy()
        else:
            h1, count = _family_hashes(flat, starts, lengths, factorization, p.seed, device)
        if not p.use64:
            h1 = h1 & np.uint64(0xFFFFFFFF)

        pos = 0
        for (rid, _), take in zip(reads, takes.tolist()):
            if take == 0:
                continue
            sizes = count[pos : pos + take]
            length = int(sizes.sum()) + (int(sizes[0]) if bug_compat_length else 0)
            self.references.append(
                Reference(
                    name=rid,
                    comment=f"FingerPrint : {rid}",
                    length=length,
                    hashes=h1[pos : pos + take],
                )
            )
            pos += take
        self._create_index()

    def init_from_files(self, files: list[str]) -> None:
        """Load ``.msh`` inputs (Sketch::initFromFiles for sketch files).

        Sketching sequence files (the classic k-mer MinHash path) is not
        ported yet.
        """
        for path in files:
            if not path.endswith(".msw" if self.params.windowed else ".msh"):
                raise NotImplementedError(
                    f"{path}: sketching sequence files (classic k-mer MinHash) is not "
                    "ported yet (ROADMAP slice 3); give .msh sketches, or "
                    "fingerprints with -fp"
                )
            self.load_msh(path)
        self._create_index()

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    def load_msh(self, path: str, truncate: bool = True) -> None:
        """Load a ``.msh``; adopt its parameters; truncate each hash list
        to the active sketch_size like loadCapnp (Sketch.cpp:1117-1120)."""
        from fpmash_tpu_torch.utils.msh import read_msh

        m = read_msh(path)
        self.params = replace(
            self.params,
            kmer_size=m.kmer_size,
            sketch_size=m.min_hashes_per_window,
            seed=m.hash_seed,
            noncanonical=m.noncanonical,
            preserve_case=m.preserve_case,
            alphabet=m.alphabet,
            concatenated=m.concatenated,
            error=m.error,
            window_size=m.window_size,
            windowed=bool(m.loci) or m.window_size > 0,
        )
        cap = self.params.sketch_size
        for r in m.references:
            hashes = r.hashes64 if self.params.use64 else r.hashes32
            hashes = np.asarray(hashes if hashes is not None else [], np.uint64)
            if truncate and len(hashes) > cap:
                hashes = hashes[:cap]
            self.references.append(
                Reference(name=r.name, comment=r.comment, length=r.length, hashes=hashes)
            )
        self._create_index()

    def write_msh(self, path: str) -> None:
        from fpmash_tpu_torch.utils.msh import MshFile, MshReference, write_msh

        p = self.params
        m = MshFile(
            kmer_size=p.kmer_size,
            window_size=p.window_size,
            min_hashes_per_window=p.sketch_size,
            concatenated=p.concatenated,
            error=p.error,
            noncanonical=p.noncanonical,
            alphabet=p.alphabet,
            preserve_case=p.preserve_case,
            hash_seed=p.seed,
        )
        for r in self.references:
            mr = MshReference(name=r.name, comment=r.comment, length=int(r.length))
            if p.use64:
                mr.hashes64 = np.asarray(r.hashes, np.uint64)
            else:
                mr.hashes32 = np.asarray(r.hashes, np.uint64).astype(np.uint32)
            m.references.append(mr)
        with trace("write-msh", references=len(m.references)):
            write_msh(path, m)

    # ------------------------------------------------------------------ #

    def _create_index(self) -> None:
        self._index_by_id = {r.name: i for i, r in enumerate(self.references)}

    def reference_index(self, name: str) -> int:
        """Index of reference ``name``, or -1 (Sketch.cpp:189-200)."""
        return self._index_by_id.get(name, -1)

    def __len__(self) -> int:
        return len(self.references)

    def check_compatible(self, other: "Sketch") -> list[str]:
        """Parameter compatibility warnings (Sketch.cpp:277-309 /
        CommandDistance.cpp:146-155 semantics)."""
        issues = []
        a, b = self.params, other.params
        if a.kmer_size != b.kmer_size:
            issues.append(f"kmer size mismatch ({a.kmer_size} vs {b.kmer_size})")
        if a.alphabet != b.alphabet:
            issues.append("alphabet mismatch")
        if a.noncanonical != b.noncanonical:
            issues.append("canonicality mismatch")
        if a.seed != b.seed:
            issues.append(f"seed mismatch ({a.seed} vs {b.seed})")
        if a.preserve_case != b.preserve_case:
            issues.append("case handling mismatch")
        return issues


def sketch_from_arrays(params: Mapping, refs: Iterable[Mapping]) -> Sketch:
    """A :class:`Sketch` from plain fields.

    ``params`` maps :class:`SketchParams` field names to values (for
    example ``dataclasses.asdict`` of the JAX package's ``SketchParams``);
    each of ``refs`` maps ``name``, ``comment``, ``length`` and ``hashes``
    (u64 values) of one reference.
    """
    sk = Sketch(SketchParams(**params))
    for r in refs:
        sk.references.append(
            Reference(
                name=r["name"],
                comment=r["comment"],
                length=int(r["length"]),
                hashes=np.asarray(r["hashes"], np.uint64),
            )
        )
    sk._create_index()
    return sk


def _hash_u64_vectors(vecs, seed: int, use64: bool, device) -> np.ndarray:
    """Hash a list of u64 vectors on ``device``; returns u64 hashes (their
    low 32 bits unless ``use64``)."""
    from fpmash_tpu_torch.ops.murmur3 import murmur3_u64_batch

    if not vecs:
        return np.zeros(0, np.uint64)
    arr = np.zeros((len(vecs), max(1, max(len(v) for v in vecs))), np.uint64)
    cnt = np.zeros(len(vecs), np.int64)
    for i, v in enumerate(vecs):
        arr[i, : len(v)] = v
        cnt[i] = len(v)
    h1, _ = murmur3_u64_batch(
        torch.from_numpy(arr.view(np.int64)).to(device), torch.from_numpy(cnt).to(device), seed
    )
    h1 = h1.cpu().numpy().view(np.uint64)
    return h1 if use64 else h1 & np.uint64(0xFFFFFFFF)


def _family_hashes(flat, starts, lengths, factorization: str, seed: int, device):
    """``(h1 u64[B], count int32[B])`` of the windows for a family other
    than CFL: kernels ``factor_words`` then ``hash_words`` on ``device``, the
    scalar model for the rows ``models/fingerprint.py`` routes there."""
    from fpmash_tpu_torch.models.fingerprint import family_words
    from fpmash_tpu_torch.ops.icfl_cuda import hash_words
    from fpmash_tpu_torch.scalar.murmur3 import hash_u64_vector

    idx, words, dev_lengths, scalar = family_words(flat, starts, lengths, factorization, device)
    h1 = np.zeros(len(lengths), np.uint64)
    count = np.zeros(len(lengths), np.int32)
    with trace("hash-words", windows=len(idx)):
        h1_d, _, count_d = hash_words(words, dev_lengths, seed)
        h1[idx] = h1_d.cpu().numpy().view(np.uint64)
        count[idx] = count_d.cpu().numpy()
    for b, vec in scalar.items():
        h1[b] = hash_u64_vector(vec, seed, use64=True)
        count[b] = len(vec)
    return h1, count
