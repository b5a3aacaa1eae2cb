"""Sketch engine: the MinHash container and its construction paths.

Port of :mod:`fpmash_tpu.models.sketch` (``mash/src/mash/Sketch.{h,cpp}``).
A sketch is a host-side list of references whose hash arrays (or, windowed,
loci) are computed on the chosen device:

* ``sketch -fp`` (:meth:`Sketch.init_from_fingerprints`, Sketch.cpp:56-151):
  every fingerprint line is one MurmurHash3 of its u64 length vector, kept
  in file order, unsorted, with no bottom-k — all lines of all files are
  hashed in one batch (``ops/murmur3.py``).
* ``sketch --direct-fp`` (:meth:`Sketch.init_from_reads_fingerprint`): reads
  -> shift windows -> factor lengths of any of the ten families -> hash,
  without writing the fingerprint text: CFL in one kernel
  (``ops/fused_cuda.py``), the other families in two (``ops/icfl_cuda.py``).
* classic k-mer MinHash (:meth:`Sketch.init_from_files`,
  :meth:`Sketch.init_from_reads`; sketchFile / sketchSequence,
  Sketch.cpp:1299-1526): the bottom-s distinct canonical k-mer hashes of
  each file (or record, ``-i``; or of all reads, ``-r``), with counts
  (``-M``, reads mode).  Inputs of at least ``_DIRECT_CHUNK / 8`` bases go
  the direct route: chunks of ``_DIRECT_CHUNK`` bases, each sketched on the
  device (``ops/kmers.classic_sketch_device``: hash kernel K5 or K6 with the
  threshold inside), merged on the host.  Smaller inputs, ``k <= 16``,
  other alphabets, ``-b`` and ``-c`` go the pool path: every k-mer hash
  (K7/K8, ``ops/kmers.kmer_hashes``), then one bottom-k over the pool.
  ``--device cpu`` takes the same routes with the kernels' plain versions.
* windowed sketches (``sketch -W``, ``.msw``; sketchSequence,
  Sketch.cpp:1504-1507, and getMinHashPositions, :737-1047): one reference
  per record with no hash list, and *loci* ``(reference, position, hash)``:
  the k-mer hash at every position (:func:`position_hashes`, K7/K8), then
  the minmers of windows of ``-L`` positions (``ops/winnow.py``).
* ``screen`` and ``taxscreen``'s query side (:func:`distinct_kmer_counts`):
  the distinct k-mer hashes of a record stream (:func:`record_stream`, or
  :func:`translated_stream` for amino-acid sketches) and their counts.

The routes that shard take ``devices`` (``device.resolve_devices``: several
cards, or several shards of one device) and gather on ``devices[0]``:
``--direct-fp`` shards its windows and the classic routes their chunks and
launches over them, as the JAX package does over its visible devices; the
sketch is bit for bit that of one device.  The others take ``device``.

Persistence is the byte-compatible ``.msh`` codec of ``utils/msh.py``.
The sketch is the state this system carries between commands, as weights
are a model's; :func:`sketch_from_arrays` builds one from plain fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Iterable, Mapping

import numpy as np
import torch

from fpmash_tpu_torch.device import to_device, to_host
from fpmash_tpu_torch.ops.bottomk import distinct_counts
from fpmash_tpu_torch.parallel.sharded import shard_windows
from fpmash_tpu_torch.utils.trace import trace

#: global fingerprint line cap across all files (Sketch.cpp:37,82)
LIMIT_READ_FINGERPRINT = 1_000_000

#: bases per chunk of the direct classic route; the route's gate and the
#: K5/K6 thresholds are sized on it (tests shrink it to exercise the merge)
_DIRECT_CHUNK = 1 << 24

#: positions hashed per kernel launch on the pool path (bounds its memory)
_POOL_CHUNK = 1 << 22

#: reads hashed between two coverage estimates of ``-c`` (Sketch.cpp:1410-1414)
_TARGET_COV_READS = 256

#: positions hashed per launch by :func:`position_hashes`, by device type
#: (tests shrink them to cross chunk edges)
_POSITION_CHUNK = {"cuda": 1 << 24, "cpu": 1 << 16}

#: windows hashed again over their raw bytes per batch (:func:`position_hashes`)
_REHASH_BATCH = 1 << 20


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

    def adopting(self, m) -> "SketchParams":
        """These parameters with those of the ``.msh`` header ``m`` (an
        ``utils.msh.MshFile``), as loading a sketch adopts them."""
        return replace(
            self,
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
    counts: np.ndarray | None = None
    counts_sorted: bool = False


class Sketch:
    """Container of sketched references + parameters."""

    def __init__(self, params: SketchParams | None = None):
        self.params = params or SketchParams()
        self.references: list[Reference] = []
        self._index_by_id: dict[str, int] = {}
        #: windowed loci: (reference index, position, hash64)
        self.loci: list[tuple[int, int, int]] = []
        self._loci_by_hash: dict[int, list[tuple[int, int]]] = {}

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
        devices,
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
        then ``hash_words`` (``ops/icfl_cuda.py``), with the host factorizer for
        the rows ``models/fingerprint.py`` routes there.  The windows are
        sharded over ``devices`` in contiguous blocks, each shard shipped
        only its span of the stream (``parallel/sharded.shard_windows``).
        """
        from fpmash_tpu_torch.models.fingerprint import window_stream
        from fpmash_tpu_torch.ops.factorize import plan

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
            hashes = partial(_cfl_hashes, seed=p.seed)
        else:
            hashes = partial(_family_hashes, factorization=factorization, seed=p.seed)
        with trace("factorize+hash", windows=n_windows, shards=len(devices)):
            h1, count = shard_windows(hashes, flat, starts, lengths, devices)
            h1 = to_host(h1).view(np.uint64)
            count = to_host(count)
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

    # ------------------------------------------------------------------ #
    # classic sequence path
    # ------------------------------------------------------------------ #

    def init_from_sequences(
        self, records, name: str = "", comment: str = "", merge: bool = False, *, devices,
    ) -> None:
        """Sketch sequence records ``(name, comment, seq)`` (classic k-mer
        MinHash).  ``merge=True``: all records feed one reference
        (concatenated and reads mode); otherwise one reference per record
        (``-i``, sketchFileBySequence).  Records shorter than ``k`` are
        skipped.  Windowed parameters give one reference per record and its
        loci (``merge`` never applies: COMMAND_FIND builds force
        concatenated=false, sketchParameterSetup.cpp:20-24).  The classic
        routes' chunks and launches are sharded over ``devices``; windowed
        sketches run on ``devices[0]``."""
        p = self.params
        if p.windowed:
            self._init_windowed(records, name, comment, devices[0])
            return
        if not merge:
            for rname, rcomment, seq in records:
                if len(seq) < p.kmer_size:
                    continue
                values, counts = _sketch_pools([seq], p, devices)
                self.references.append(
                    Reference(
                        name=name or rname,
                        comment=comment or rcomment,
                        length=len(seq),
                        hashes=values,
                        counts=counts if p.counts else None,
                        counts_sorted=p.counts,
                    )
                )
            self._create_index()
            return

        with trace("records", records=len(records)):
            records = [r for r in records if len(r[2]) >= p.kmer_size]
            pools = [seq for _, _, seq in records]
            first = records[0] if records else None
            first_name, first_comment = (first[0], first[1]) if first else ("", "")
            count = len(pools)
            total_len = sum(map(len, pools))
        if p.reads and p.target_cov > 0:
            values, counts, count = _sketch_to_coverage(pools, p, devices)
        else:
            values, counts = _sketch_pools(pools, p, devices)
        if p.reads:
            # reads mode stores the cardinality estimate as the length
            # (sketchFile, Sketch.cpp:1425-1436)
            from fpmash_tpu_torch.ops.bottomk import estimate_set_size

            bits = 64 if p.use64 else 32
            total_len = int(estimate_set_size(values, p.sketch_size, bits))
        # the first record's "name comment"; several records get the
        # "[N seqs] ... [...]" wrapper (Sketch.cpp:1438-1446).  A name alone
        # loses its trailing blanks (a CRLF header's "\r"), as in the JAX
        # package.
        rcomment = comment
        if not rcomment:
            rcomment = (first_name + " " + first_comment) if first_comment else first_name.rstrip()
            if count > 1:
                rcomment = f"[{count} seqs] {rcomment} [...]"
        self.references.append(
            Reference(
                name=name or first_name,
                comment=rcomment,
                length=total_len,
                hashes=values,
                counts=counts if p.counts else None,
                counts_sorted=p.counts,
            )
        )
        self._create_index()

    def _init_windowed(self, records, name: str, comment: str, device) -> None:
        from fpmash_tpu_torch.ops.winnow import minmer_positions

        p = self.params
        for rname, rcomment, seq in records:
            if len(seq) < p.kmer_size:
                continue
            ref_idx = len(self.references)
            with trace("position-hashes", bases=len(seq)):
                ph = position_hashes(seq, p, device)
            with trace("minmers", positions=ph.numel(), window=p.window_size):
                positions, phashes = minmer_positions(ph, p.window_size, p.sketch_size,
                                                      device=device)
            self.references.append(
                Reference(name=name or rname, comment=comment or rcomment, length=len(seq))
            )
            self.loci.extend((ref_idx, pos, h)
                             for pos, h in zip(positions.tolist(), phashes.tolist()))
        self._create_index()

    def init_from_files(self, files: list[str], individual: bool = False, *, devices) -> None:
        """Sketch FASTA/FASTQ files, and load ``.msh`` ones (Sketch::initFromFiles).

        A sequence file gives one reference named after its path, with the
        first record's comment (sketchFile, Sketch.cpp:1299-1488), or with
        ``individual`` (or windowed parameters) one reference per record.  A
        ``.msh`` (windowed: ``.msw``, Sketch.cpp:257) loads with the load-time
        truncation rule.  ``devices``: see :meth:`init_from_sequences`.
        """
        from fpmash_tpu_torch.utils.fasta import read_sequences, reader

        for path in files:
            if path.endswith(".msw" if self.params.windowed else ".msh"):
                self.load_msh(path)
                continue
            with trace("read-sequences", file=path, reader=reader(path)):
                records = list(read_sequences(path))
            if individual or self.params.windowed:
                self.init_from_sequences(records, devices=devices)
            else:
                self.init_from_sequences(records, name=path, merge=True, devices=devices)
        self._create_index()

    def init_from_reads(
        self, files: list[str], name: str = "", comment: str = "", *, devices
    ) -> None:
        """Reads mode: all records of all files form one reference
        (Sketch::initFromReads, Sketch.cpp:203-247).  ``devices``: see
        :meth:`init_from_sequences`."""
        from fpmash_tpu_torch.utils.fasta import read_sequences, reader

        records = []
        readers = sorted({reader(path) for path in files})
        with trace("read-sequences", files=len(files), reader="|".join(readers)):
            for path in files:
                records.extend(read_sequences(path))
        self.init_from_sequences(
            records, name=name or (files[0] if files else ""), comment=comment, merge=True,
            devices=devices,
        )

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    def load_msh(self, path: str, truncate: bool = True) -> None:
        """Load a ``.msh``; adopt its parameters; truncate each hash list
        to the active sketch_size like loadCapnp (Sketch.cpp:1117-1120)."""
        from fpmash_tpu_torch.utils.msh import read_msh

        m = read_msh(path)
        self.params = self.params.adopting(m)
        base = len(self.references)
        self.loci.extend((base + int(s), int(pos), int(h)) for s, pos, h in m.loci)
        cap = self.params.sketch_size
        for r in m.references:
            hashes = r.hashes64 if self.params.use64 else r.hashes32
            hashes = np.asarray(hashes if hashes is not None else [], np.uint64)
            if truncate and len(hashes) > cap:
                hashes = hashes[:cap]
            counts = None
            if r.counts32 is not None:
                counts = np.asarray(r.counts32, np.uint32)[: len(hashes)]
            self.references.append(
                Reference(name=r.name, comment=r.comment, length=r.length, hashes=hashes,
                          counts=counts, counts_sorted=r.counts32_sorted)
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
        with trace("msh-refs", references=len(self.references)):
            for r in self.references:
                with_counts = r.counts is not None and p.counts
                mr = MshReference(name=r.name, comment=r.comment, length=int(r.length),
                                  counts32_sorted=bool(r.counts_sorted and with_counts))
                if p.use64:
                    mr.hashes64 = np.asarray(r.hashes, np.uint64)
                else:
                    mr.hashes32 = np.asarray(r.hashes, np.uint64).astype(np.uint32)
                if with_counts:
                    mr.counts32 = np.asarray(r.counts, np.uint32)
                m.references.append(mr)
        m.loci = list(self.loci)
        with trace("write-msh", references=len(m.references)):
            write_msh(path, m)

    # ------------------------------------------------------------------ #

    def _create_index(self) -> None:
        self._index_by_id = {r.name: i for i, r in enumerate(self.references)}
        # hash -> [(reference index, position)] (createIndex, Sketch.cpp:644-662)
        self._loci_by_hash = {}
        for seq_idx, pos, h in self.loci:
            self._loci_by_hash.setdefault(h, []).append((seq_idx, pos))

    def loci_by_hash(self, h: int) -> list[tuple[int, int]]:
        return self._loci_by_hash.get(int(h), [])

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
    (u64 values) of one reference, and optionally ``counts`` (u32 values or
    None) and ``counts_sorted``.
    """
    sk = Sketch(SketchParams(**params))
    for r in refs:
        counts = r.get("counts")
        sk.references.append(
            Reference(
                name=r["name"],
                comment=r["comment"],
                length=int(r["length"]),
                hashes=np.asarray(r["hashes"], np.uint64),
                counts=None if counts is None else np.asarray(counts, np.uint32),
                counts_sorted=bool(r.get("counts_sorted", False)),
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
    h1, _ = murmur3_u64_batch(to_device(arr, device), to_device(cnt, device), seed)
    h1 = to_host(h1).view(np.uint64)
    return h1 if use64 else h1 & np.uint64(0xFFFFFFFF)


def _cfl_hashes(flat, starts, lengths, device, *, seed: int):
    """``(h1 int64[B], count int32[B])`` on ``device`` of the windows
    ``flat[starts[b] : starts[b] + lengths[b]]`` of host arrays: kernel K1."""
    from fpmash_tpu_torch.ops.fused_cuda import fingerprint_hashes

    h1, _, count = fingerprint_hashes(to_device(flat, device), to_device(starts, device),
                                      to_device(lengths, device), seed)
    return h1, count


def _family_hashes(flat, starts, lengths, device, *, factorization: str, seed: int):
    """:func:`_cfl_hashes` for a family other than CFL: kernels
    ``factor_words`` then ``hash_words`` on ``device``, the host factorizer for
    the rows ``models/fingerprint.py`` routes there."""
    from fpmash_tpu_torch.models.fingerprint import family_words
    from fpmash_tpu_torch.ops.icfl_cuda import hash_words
    from fpmash_tpu_torch.ops.murmur3 import to_signed
    from fpmash_tpu_torch.scalar.murmur3 import hash_u64_vector

    idx, words, dev_lengths, scalar = family_words(flat, starts, lengths, factorization, device)
    h1 = torch.zeros(len(lengths), dtype=torch.int64, device=device)
    count = torch.zeros(len(lengths), dtype=torch.int32, device=device)
    with trace("hash-words", windows=len(idx)):
        rows = to_device(idx, device)
        h1[rows], _, count[rows] = hash_words(words, dev_lengths, seed)
    if scalar:
        rows = to_device(np.array(list(scalar), np.int64), device)
        h1[rows] = to_device(np.array([to_signed(hash_u64_vector(v, seed, use64=True))
                                       for v in scalar.values()], np.int64), device)
        count[rows] = to_device(np.array([len(v) for v in scalar.values()], np.int32), device)
    return h1, count


# ---------------------------------------------------------------------- #
# classic routes
# ---------------------------------------------------------------------- #


def _blob(seqs, k: int) -> np.ndarray:
    """All sequences as one ``uint8`` stream, separated by ``k - 1`` NUL
    bytes (outside every alphabet), so no valid window spans two records."""
    with trace("blob", records=len(seqs)):
        sep = b"\x00" * (k - 1)
        joined = sep.join(s.encode("ascii", "replace") if isinstance(s, str) else bytes(s)
                          for s in seqs)
        return np.frombuffer(joined, np.uint8)


def _to_host(values: torch.Tensor, counts: torch.Tensor, n: int):
    return to_host(values[:n]).view(np.uint64), to_host(counts[:n]).astype(np.uint32)


def _sketch_pools(seqs: list[str], p: SketchParams, devices):
    """``(values u64, counts u32)`` of one reference: the direct route
    where it applies (:func:`_classic_sketch_direct`), else the pool path;
    either one sharded over ``devices``."""
    direct = _classic_sketch_direct(seqs, p, devices)
    if direct is not None:
        return direct
    with trace("kmer-hash", bases=sum(map(len, seqs))):
        hashes = _kmer_hash_pool(seqs, p, devices)
    with trace("bottom-k", pool=hashes.numel()):
        return _bottom_k(hashes, p)


def _sketch_to_coverage(pools: list[str], p: SketchParams, devices):
    """``-c``: hash reads in batches, re-estimate the kept sketch's mean
    multiplicity after each, and stop once it reaches ``target_cov``
    (sketchFile, Sketch.cpp:1410-1414).  Returns ``(values, counts, reads
    used)``."""
    from fpmash_tpu_torch.ops.bottomk import estimate_multiplicity

    hashes = torch.zeros(0, dtype=torch.int64, device=devices[0])
    values, counts = np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    used = 0
    while used < len(pools):
        batch = pools[used : used + _TARGET_COV_READS]
        used += len(batch)
        hashes = torch.cat([hashes, _kmer_hash_pool(batch, p, devices)])
        values, counts = _bottom_k(hashes, p)
        if len(values) >= p.sketch_size and estimate_multiplicity(counts) >= p.target_cov:
            break
    return values, counts, used


def _direct_chunk(blob: np.ndarray, pos: int, device):
    """The direct route's chunk at ``pos``: ``_DIRECT_CHUNK`` bytes on the
    device (zero-padded at the end of the stream) and its valid length.
    Windows starting in the last ``k - 1`` bytes of a chunk that is not the
    last lie past ``length - k`` and belong to the next chunk."""
    end = min(pos + _DIRECT_CHUNK, len(blob))
    buf = np.zeros(_DIRECT_CHUNK, np.uint8)
    buf[: end - pos] = blob[pos:end]
    length = end - pos if end == len(blob) else _DIRECT_CHUNK
    return to_device(buf, device), length


def _merge_counts(vals: list[np.ndarray], counts: list[np.ndarray]):
    """Distinct values of the chunks' results, ascending, with their counts summed."""
    v = np.concatenate(vals) if vals else np.zeros(0, np.uint64)
    c = np.concatenate(counts).astype(np.uint64) if counts else np.zeros(0, np.uint64)
    distinct, inverse = np.unique(v, return_inverse=True)
    total = np.zeros(len(distinct), np.uint64)
    np.add.at(total, inverse, c)
    return distinct, total


def _classic_sketch_direct(seqs: list[str], p: SketchParams, devices):
    """The direct classic route: the stream in chunks of ``_DIRECT_CHUNK``
    bases (overlapping by ``k - 1``), each sketched on the device by
    :func:`~fpmash_tpu_torch.ops.kmers.classic_sketch_device`, so only
    ``s``-sized results leave it; the chunks' bottom-s merge on the host.

    The merge is exact: a value of the global bottom-s has fewer than ``s``
    smaller distinct values in any chunk where it occurs, so it is in that
    chunk's bottom-s with its full count there; values unite and counts
    add.  A chunk whose threshold collected too few values retries at boost
    2; if that also fails, the chunk is hashed in full
    (:func:`_chunk_pool_bottom_k`).  ``min_cov > 1`` takes
    :func:`_direct_reads_sketch`.

    Chunk ``i`` runs on ``devices[i % D]``, in two
    phases as in the JAX route (``fpmash_tpu/models/sketch.py:926-960``):
    every chunk is dispatched at boost 1, keeping only its result on its
    device, then the results are read in chunk order and the retries
    dispatched, then read.  A chunk's buffer is not kept: a retry uploads
    it again.

    Returns ``(values, counts)``, or None where the route does not apply:
    an alphabet other than ACGT, ``k`` outside (16, 32], fewer than
    ``max(4096, _DIRECT_CHUNK / 8)`` bases (below that the chunk-sized
    threshold cannot promise ``s`` candidates within the boost ladder), or
    ``-b``.
    """
    from fpmash_tpu_torch.ops.kmers import classic_sketch_device

    k = p.kmer_size
    if not seqs or set(p.alphabet) != set("ACGT") or not 16 < k <= 32:
        return None
    if p.bloom_bytes > 0 and p.reads:
        return None  # the Bloom admission is order-dependent: the pool path keeps the order
    blob = _blob(seqs, k)
    n = len(blob)
    if n < max(4096, _DIRECT_CHUNK >> 3):
        return None
    step = _DIRECT_CHUNK - (k - 1)
    # a tail shorter than k holds no window
    starts = [pos for pos in range(0, n, step) if min(pos + _DIRECT_CHUNK, n) - pos >= k]
    if p.min_cov > 1:
        return _direct_reads_sketch(blob, starts, p, devices)
    need_counts = bool(p.counts or p.target_cov > 0)

    def dispatch(ci, boost):
        buf, length = _direct_chunk(blob, starts[ci], devices[ci % len(devices)])
        return buf, length, classic_sketch_device(
            buf, length, k=k, s=p.sketch_size, noncanonical=p.noncanonical,
            preserve_case=p.preserve_case, seed=p.seed, boost=boost, need_counts=need_counts,
        )

    with trace("classic-direct", bases=n, chunks=len(starts), shards=len(devices)):
        wave = [dispatch(ci, 1)[2] for ci in range(len(starts))]
        results = [_to_host(v, c, nv) if ok else None for v, c, nv, ok in wave]
        retry = [(ci, *dispatch(ci, 2)) for ci, r in enumerate(results) if r is None]
        for ci, buf, length, (v, c, nv, ok) in retry:
            results[ci] = (_to_host(v, c, nv) if ok
                           else _chunk_pool_bottom_k(buf, length, p, need_counts))
    values, total = _merge_counts([v for v, _ in results], [c for _, c in results])
    if not need_counts:
        total = np.ones_like(total)  # the chunks' 1-filled counts stay 1
    return values[: p.sketch_size], total[: p.sketch_size].astype(np.uint32)


def _direct_reads_sketch(blob: np.ndarray, starts: list[int], p: SketchParams, devices):
    """The direct route for ``min_cov > 1`` (reads mode ``-m``).

    The reference admits a k-mer once it has been seen ``min_cov`` times
    (MinHashHeap.cpp:78-95).  Here every chunk returns all its distinct
    values under the threshold with exact counts (the collect-all contract;
    the threshold is the same in every chunk, since it is sized on the
    chunk), counts add across chunks, and ``min_cov`` filters after the
    merge.  The first ``s`` survivors are the sketch when there are ``s``
    of them (every value not collected lies above the threshold) or the
    threshold was saturated.  Otherwise, or when a chunk's ``out_slots``
    overflow, the whole pass runs again at boost 4, then 16; after that
    None sends the input to the pool path.  Each pass uploads the chunks
    again, one at a time, chunk ``i`` to ``devices[i % D]``; every chunk of a
    pass is dispatched before any result is read, as in the JAX route
    (``fpmash_tpu/models/sketch.py:1044-1060``).
    """
    from fpmash_tpu_torch.ops.kmers import chunk_threshold, classic_sketch_device

    k, s = p.kmer_size, p.sketch_size
    for boost in (1, 4, 16):
        sat = chunk_threshold(_DIRECT_CHUNK, k, s, boost)[1]
        with trace("classic-direct-reads", boost=boost, chunks=len(starts),
                   shards=len(devices)):
            wave = [
                classic_sketch_device(
                    *_direct_chunk(blob, pos, devices[ci % len(devices)]), k=k, s=s,
                    noncanonical=p.noncanonical, preserve_case=p.preserve_case, seed=p.seed,
                    boost=boost, out_slots=16 * s * boost,
                )
                for ci, pos in enumerate(starts)
            ]
            if not all(ok for *_, ok in wave):
                continue  # a chunk's slots overflowed: the next boost
            host = [_to_host(v, c, nv) for v, c, nv, _ in wave]
            values, total = _merge_counts([v for v, _ in host], [c for _, c in host])
            keep = total >= p.min_cov
            values, total = values[keep], total[keep]
            if len(values) >= s or sat:
                return values[:s], total[:s].astype(np.uint32)
    return None


def _chunk_pool_bottom_k(buf: torch.Tensor, length: int, p: SketchParams, need_counts: bool):
    """One direct-route chunk whose boost ladder under-collected: every
    window hashed (K7), then an exact bottom-s of the chunk."""
    from fpmash_tpu_torch.ops.bottomk import bottom_k_distinct
    from fpmash_tpu_torch.ops.kmers import kmer_hashes

    h, valid = kmer_hashes(
        buf, length, alphabet=p.alphabet, k=p.kmer_size, noncanonical=p.noncanonical,
        preserve_case=p.preserve_case, seed=p.seed,
    )
    values, counts, n = bottom_k_distinct(h, valid, s=p.sketch_size)
    values, counts = _to_host(values, counts, n)
    return values, counts if need_counts else np.ones_like(counts)


def _kmer_hash_pool(seqs: list[str], p: SketchParams, devices) -> torch.Tensor:
    """Every valid k-mer hash of every sequence, in stream order, as one
    ``int64`` tensor on ``devices[0]`` (low 32 bits unless ``use64``): the
    hashes of their stream (:func:`_blob`, :func:`_kmer_hash_stream`)."""
    return _kmer_hash_stream(torch.from_numpy(_blob(seqs, p.kmer_size).copy()), p, devices)


def _kmer_hash_stream(stream: torch.Tensor, p: SketchParams, devices) -> torch.Tensor:
    """Every valid k-mer hash of a ``uint8`` stream of records separated by
    ``k - 1`` NUL bytes (:func:`_blob`, :func:`record_stream`), on the host
    or on a device, in stream order, as one ``int64`` tensor on
    ``devices[0]`` (low 32 bits unless ``use64``).

    The stream is hashed in launches of ``_POOL_CHUNK`` positions that
    overlap by ``k - 1`` bytes.  Launch ``i`` runs on ``devices[i % D]``
    (the stream is put on each of them once), the launches go in rounds of
    one a shard, and the hashes are gathered on ``devices[0]`` in stream
    order, which the Bloom admission of ``-b`` depends on.
    """
    from fpmash_tpu_torch.ops.kmers import kmer_hashes

    k = p.kmer_size
    n = stream.numel()
    starts = []
    for pos in range(0, n, _POOL_CHUNK - (k - 1)):
        starts.append(pos)
        if pos + _POOL_CHUNK >= n:
            break
    streams = {}
    parts = [torch.zeros(0, dtype=torch.int64, device=devices[0])]
    for r0 in range(0, len(starts), len(devices)):
        launched = []
        for pos, dev in zip(starts[r0 : r0 + len(devices)], devices):
            if dev not in streams:
                streams[dev] = to_device(stream, dev)
            end = min(pos + _POOL_CHUNK, n)
            launched.append(kmer_hashes(
                streams[dev][pos:end], end - pos, alphabet=p.alphabet, k=k,
                noncanonical=p.noncanonical, preserve_case=p.preserve_case, seed=p.seed,
            ))
        parts.extend(h[valid].to(devices[0]) for h, valid in launched)
    out = torch.cat(parts)
    return out if p.use64 else out & 0xFFFFFFFF


def record_stream(paths: list[str], k: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """The records of the sequence files ``paths``, in order, as one ``uint8``
    stream on ``device`` separated by ``k - 1`` NUL bytes, the stream that
    :func:`_blob` makes of their sequences; and the records' lengths (host
    ``int64``).  Traced as ``record-stream``.

    A plain file's records come from the native reader as one buffer and
    its offsets (``utils/native.parse_seq_file``), with no Python object a
    record; ``.gz`` and ``-`` through the Python reader.  The records go to
    the device back to back, and the separators are put in there by one
    scatter.  A record shorter than ``k`` stays in: no
    window that touches it is valid, so the k-mers are those of the stream
    without it.
    """
    from fpmash_tpu_torch.utils.fasta import read_sequences, reader

    with trace("record-stream", files=len(paths)):
        data, lengths = [], []
        for path in paths:
            if reader(path) == "native":
                from fpmash_tpu_torch.utils.native import parse_seq_file

                _, _, blob, offsets = parse_seq_file(path)
                data.append(np.frombuffer(blob, np.uint8))
                lengths.append(np.diff(offsets))
            else:
                seqs = [r.seq.encode("ascii", "replace") for r in read_sequences(path)]
                data.append(np.frombuffer(b"".join(seqs), np.uint8))
                lengths.append(np.fromiter(map(len, seqs), np.int64, len(seqs)))
        data = data[0] if len(data) == 1 else np.concatenate(data)
        lengths = np.concatenate(lengths) if lengths else np.zeros(0, np.int64)
        records = len(lengths)
        body = to_device(data, device)
        if records <= 1 or k == 1:
            return body, lengths
        ids = torch.repeat_interleave(torch.arange(records, device=body.device),
                                      to_device(lengths, device), output_size=body.numel())
        where = ids.mul_(k - 1).add_(torch.arange(body.numel(), device=body.device))
        stream = torch.zeros(body.numel() + (k - 1) * (records - 1), dtype=torch.uint8,
                             device=body.device)
        stream[where] = body
        return stream, lengths


def translated_stream(paths: list[str], p: SketchParams) -> tuple[torch.Tensor, np.ndarray]:
    """The six-frame translations of every record of at least ``k`` bases
    of the sequence files ``paths`` (``utils/codon.py``), joined into one
    host stream as :func:`_blob` joins sequences, and their lengths: the
    query of an amino-acid sketch against a nucleotide mixture (upstream
    screen; hashSequence, CommandScreen.cpp:311-376)."""
    from fpmash_tpu_torch.utils.codon import six_frame_translations
    from fpmash_tpu_torch.utils.fasta import read_sequences

    seqs = [t for path in paths for rec in read_sequences(path)
            if len(rec.seq) >= p.kmer_size
            for t in six_frame_translations(rec.seq, p.preserve_case)]
    return (torch.from_numpy(_blob(seqs, p.kmer_size).copy()),
            np.fromiter(map(len, seqs), np.int64, len(seqs)))


def distinct_kmer_counts(stream: torch.Tensor, lengths: np.ndarray, p: SketchParams, devices):
    """Distinct hash values and multiplicities of every valid k-mer of a
    record stream (:func:`record_stream` or :func:`translated_stream`, with
    its records' ``lengths``): ``(values, counts)``, ``int64`` tensors on
    ``devices[0]``, the values ascending as unsigned.

    Counterpart of ``fpmash_tpu/models/sketch.py:1247``, the query side of
    ``screen`` and ``taxscreen`` (CommandScreen.cpp:81-151): the stream's
    k-mers are hashed (:func:`_kmer_hash_stream`: K7 for ``16 < k <= 32``,
    K8 for ``k <= 16``, collapsed to 32 bits unless ``use64``; its launches
    sharded over ``devices``) and counted where they are
    (:func:`~fpmash_tpu_torch.ops.bottomk.distinct_counts`).
    """
    with trace("kmer-hash", bases=int(lengths.sum())):
        pool = _kmer_hash_stream(stream, p, devices)
    with trace("distinct-counts", pool=pool.numel()):
        return distinct_counts(pool)


def position_hashes(seq, p: SketchParams, device) -> torch.Tensor:
    """Hash of the k-mer at every start position of ``seq``, in order, as an
    ``int64`` tensor on ``device`` (low 32 bits unless ``use64``).

    The scalar model's hashes (getMinHashPositions, Sketch.cpp:837): the raw
    bytes as they are, with no case folding, no canonical strand and no
    alphabet filter.  For the DNA alphabet and ``k <= 32`` the hash kernels
    run non-canonical and case-preserving (K7 for ``16 < k``, K8 below;
    ``ops/kmers_cuda.kmer_hashes_planes``) in launches of
    ``_POSITION_CHUNK`` positions overlapping by ``k - 1``; every window
    they mark invalid, one with a byte outside upper-case ``ACGT``, is hashed
    again over its raw bytes (``ops/murmur3.murmur3_bytes_batch``), as are
    all windows of other alphabets or ``k > 32``.  The JAX package's device
    route keeps the packed hash there, which reads such a byte as ``T``; its
    scalar route does not, and the port follows the scalar route.
    """
    from fpmash_tpu_torch.ops.kmers_cuda import join_planes, kmer_hashes_planes
    from fpmash_tpu_torch.ops.murmur3 import murmur3_bytes_batch

    k = p.kmer_size
    b = seq.encode("ascii", "replace") if isinstance(seq, str) else bytes(seq)
    n = len(b)
    if n < k:
        return torch.zeros(0, dtype=torch.int64, device=device)
    stream = to_device(np.frombuffer(b, np.uint8), device)
    m = n - k + 1
    out = torch.empty(m, dtype=torch.int64, device=device)
    if set(p.alphabet) == set("ACGT") and k <= 32:
        size = _POSITION_CHUNK[torch.device(device).type]
        redo = []
        for pos in range(0, m, size - (k - 1)):
            end = min(pos + size, n)
            keep = end - pos - k + 1
            lo, hi, valid = kmer_hashes_planes(stream[pos:end], k=k, noncanonical=True,
                                               preserve_case=True, seed=p.seed)
            out[pos : pos + keep] = join_planes(lo[:keep], hi[:keep])
            redo.append(pos + (~valid[:keep]).nonzero().flatten())
        redo = torch.cat(redo)
    else:
        redo = torch.arange(m, device=device)
    offsets = torch.arange(k, device=device)
    for i in range(0, redo.numel(), _REHASH_BATCH):
        idx = redo[i : i + _REHASH_BATCH]
        lengths = torch.full((idx.numel(),), k, dtype=torch.int64, device=device)
        out[idx], _ = murmur3_bytes_batch(stream[idx[:, None] + offsets], lengths, p.seed)
    return out if p.use64 else out & 0xFFFFFFFF


def _kmer_hash_pool_scalar(seqs: list[str], p: SketchParams) -> np.ndarray:
    """The scalar model of :func:`_kmer_hash_pool` (a test oracle): the
    reference's per-k-mer loop with ``hash_bytes``."""
    from fpmash_tpu_torch.ops.kmers import complement_table
    from fpmash_tpu_torch.scalar.murmur3 import hash_bytes

    ctab = complement_table()
    alpha = set(p.alphabet.encode())
    k = p.kmer_size
    out = []
    for seq in seqs:
        s = seq if p.preserve_case else seq.upper()
        b = s.encode("ascii", "replace")
        rc = bytes(ctab[c] for c in b)[::-1]
        n = len(b)
        for i in range(n - k + 1):
            kmer = b[i : i + k]
            if any(c not in alpha for c in kmer):
                continue
            if not p.noncanonical:
                rck = rc[n - i - k : n - i]
                if rck < kmer:
                    kmer = rck
            out.append(hash_bytes(kmer, seed=p.seed, use64=True))
    res = np.array(out, np.uint64) if out else np.zeros(0, np.uint64)
    return res if p.use64 else res & np.uint64(0xFFFFFFFF)


def _bottom_k(hashes: torch.Tensor, p: SketchParams):
    """Bottom-s distinct values and counts of a pool, as host arrays.

    ``-b``: the Bloom admission over the pool in stream order
    (MinHashHeap.cpp:78-95).  Pools of more than 2^17 hashes, with
    ``16 s <= 2^16``, try the threshold first (boost 1, then 8; ``ok``
    false means it collected too few); the full sort is exact.
    """
    from fpmash_tpu_torch.ops.bottomk import bottom_k_distinct, bottom_k_threshold

    s = p.sketch_size
    if p.bloom_bytes > 0 and p.reads:
        from fpmash_tpu_torch.ops.bloom import bloom_admit_counts

        values, counts = bloom_admit_counts(to_host(hashes).view(np.uint64), p.bloom_bytes)
        return values[:s], counts[:s]
    valid = torch.ones(hashes.numel(), dtype=torch.bool, device=hashes.device)
    if hashes.numel() > (1 << 17) and s * 16 <= (1 << 16):
        need_counts = bool(p.counts or p.min_cov > 1 or p.target_cov > 0)
        for boost in (1, 8):
            values, counts, n, ok = bottom_k_threshold(
                hashes, valid, s=s, min_cov=p.min_cov, boost=boost, need_counts=need_counts
            )
            if ok:
                return _to_host(values, counts, n)
    values, counts, n = bottom_k_distinct(hashes, valid, s=s, min_cov=p.min_cov)
    return _to_host(values, counts, n)
