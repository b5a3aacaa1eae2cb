"""Fingerprint front-end: reads -> Lyndon-factorization fingerprints.

Port of :mod:`fpmash_tpu.models.fingerprint` (lyn2vec lyn2vec.py +
fingerprint_utils.py).  A *fingerprint* of a read is the sequence of factor
lengths of its Lyndon/inverse-Lyndon factorization; in "shift" mode every
cyclic 100-wide window of a read is fingerprinted (fingerprint_utils.py:
95-110), in "long" mode the read is cut into fixed-size chunks that are
factorized separately and joined with ``|`` (fingerprint_utils.py:114-130,
480-518).

Factorization runs on the given device: the windows go to the card as one
flat byte stream plus a start and length per window, kernel
``factor_words`` (``ops/icfl_cuda.py``) returns each window's factor-start
bits, and the host turns bits into lengths and slices the factor strings.
Two kinds of row go to the host factorizer instead
(:mod:`fpmash_tpu_torch.utils.native_lyndon`, ``native/lyndon.cpp``, which
gives the scalar model's lengths), both chosen as the JAX package chooses
them: rows wider than :data:`~fpmash_tpu_torch.ops.icfl_cuda.MAX_ICFL_WIDTH`
for the families with an ICFL automaton (picked by shape, before any
launch), and rows whose ``ok`` flag comes back false.  :data:`SCALAR_ROWS`
counts both.  (The JAX package's rule that batches under 64 windows stay on
the host is a dispatch workaround of the TPU and is not copied: such batches
go to the card.)

Output lines are byte-compatible with the reference: ``ID len1 len2 ...``
and ``ID fac1 fac2 ...``, ``<<``/``>>`` markers stripped
(fingerprint_utils.py:461-470).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from fpmash_tpu_torch.device import to_device, to_host
from fpmash_tpu_torch.ops.factorize import plan
from fpmash_tpu_torch.ops.icfl_cuda import MAX_ICFL_WIDTH, factor_words
from fpmash_tpu_torch.scalar.lyndon import FACTORIZATIONS, reverse_complement
from fpmash_tpu_torch.utils.fasta import read_sequences
from fpmash_tpu_torch.utils.native_lyndon import factorize_flat
from fpmash_tpu_torch.utils.trace import trace

SHIFT_WINDOW = 100  # fingerprint_utils.py:456: shift_string(read, 100, shift)
MARKERS = ("<<", ">>")

#: rows this process factorized on the host: too wide for the card's ICFL
#: instances, or reported with ``ok`` false
SCALAR_ROWS = {"wide": 0, "ok_false": 0}


def extract_reads(path: str, rev_com: bool = False) -> list[tuple[str, str]]:
    """Return ``(id, SEQUENCE)`` pairs for the *basic* pipeline.

    The line ID is the FASTA header's *second* token (the gene ID — the
    reference keeps ``s_list[1]``, fingerprint_utils.py:282-289), falling
    back to the first token when there is no second.  Sequences are
    uppercased (fingerprint_utils.py:365).

    ``rev_com=True`` reproduces the reference fixtures exactly: IDs gain a
    ``_0`` suffix and — because the reference appends reverse-complement
    lines under an inverted condition that never fires
    (fingerprint_utils.py:276-277,305-306) — *no* ``_1`` reverse-complement
    reads are emitted.  ``rev_com=False`` yields plain IDs.
    """
    out = []
    for rec in read_sequences(path):
        rid = rec.comment.split()[0] if rec.comment else rec.name
        seq = rec.seq.upper()
        out.append((rid + "_0", seq) if rev_com else (rid, seq))
    return out


def extract_long_reads(path: str, rev_com: bool = False) -> list[tuple[str, str]]:
    """Return ``(id, SEQUENCE)`` pairs for the *generalized* (long-read)
    pipeline.

    Unlike :func:`extract_reads`, the long-read reader keeps the header's
    *first* token and, with ``rev_com=True``, emits both the ``_0`` forward
    and ``_1`` reverse-complement lines (fingerprint_utils.py:165-201).
    """
    out = []
    for rec in read_sequences(path):
        seq = rec.seq.upper()
        if rev_com:
            out.append((rec.name + "_0", seq))
            out.append((rec.name + "_1", reverse_complement(seq)))
        else:
            out.append((rec.name, seq))
    return out


def shift_windows(seq: str, size: int = SHIFT_WINDOW) -> list[str]:
    """All cyclic ``size``-wide windows of ``seq`` (fingerprint_utils.py:95).

    A sequence shorter than ``size`` yields itself unchanged; otherwise
    window ``i`` is ``seq[i:i+size]`` wrapping around the start.
    """
    n = len(seq)
    if n < size:
        return [seq]
    doubled = seq + seq[: size - 1]
    return [doubled[i : i + size] for i in range(n)]


def chunk_split(seq: str, size: int = 300) -> list[str]:
    """Split a long read into fixed-size chunks (fingerprint_utils.py:114)."""
    if len(seq) < size:
        return [seq]
    return [seq[i : i + size] for i in range(0, len(seq), size)]


def scalar_lengths(text: str, factorization: str) -> list[int]:
    """Factor lengths of one string by the scalar model, markers stripped."""
    if not text:
        return []
    return [len(f) for f in FACTORIZATIONS[factorization](text) if f not in MARKERS]


def window_stream(texts: Sequence[str], shift: bool):
    """One flat stream for ``texts`` and its windows.

    Each text is shipped once; with ``shift`` a text of at least
    :data:`SHIFT_WINDOW` characters is followed by its first 99 and gives
    one cyclic window per character, any other text one window of itself.
    Returns ``(stream uint8[N], starts int64[B], lengths int32[B],
    windows_per_text int64[T])``.
    """
    W = SHIFT_WINDOW
    chunks, starts, lengths, counts = [], [], [], []
    off = 0
    for text in texts:
        n = len(text)
        if shift and n >= W:
            data = (text + text[: W - 1]).encode("ascii", "replace")
            starts.append(np.arange(off, off + n, dtype=np.int64))
            lengths.append(np.full(n, W, np.int32))
            counts.append(n)
        else:
            data = text.encode("ascii", "replace")
            starts.append(np.array([off], np.int64))
            lengths.append(np.array([n], np.int32))
            counts.append(1)
        chunks.append(data)
        off += len(data)
    flat = np.frombuffer(b"".join(chunks), np.uint8).copy()
    empty64, empty32 = np.zeros(0, np.int64), np.zeros(0, np.int32)
    return (flat, np.concatenate(starts or [empty64]), np.concatenate(lengths or [empty32]),
            np.array(counts, np.int64))


def device_rows(lengths: np.ndarray, factorization: str) -> np.ndarray:
    """Whether each window goes to the card (by shape): every window of a
    Duval-only family, the others up to ``MAX_ICFL_WIDTH`` characters."""
    if plan(factorization)[0] == "cfl":
        return np.ones(len(lengths), bool)
    return lengths <= MAX_ICFL_WIDTH


def scalar_rows(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray, rows,
                factorization: str, reason: str) -> dict[int, list[int]]:
    """Factor lengths of ``rows`` by the host factorizer
    (:func:`~fpmash_tpu_torch.utils.native_lyndon.factorize_flat`, equal to
    :func:`scalar_lengths`), in a span of their own."""
    rows = np.asarray(rows, np.int64)
    SCALAR_ROWS[reason] += len(rows)
    if not len(rows):
        return {}
    with trace(f"scalar-rows:{reason}", rows=len(rows), host="native"):
        lens, offsets = factorize_flat(flat, starts[rows], lengths[rows], factorization)
        offsets = offsets.tolist()
        return {b: lens[offsets[i] : offsets[i + 1]].tolist()
                for i, b in enumerate(rows.tolist())}


def family_words(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                 factorization: str, device):
    """Factor-start words of the windows ``flat[starts[b] : starts[b] +
    lengths[b]]``: kernel ``factor_words`` on ``device`` for the rows
    :func:`device_rows` picks, the host factorizer for the others and for rows
    whose ``ok`` comes back false.

    Returns ``(idx, words, dev_lengths, scalar)``: the card's rows ``idx``,
    their words and lengths on ``device``, and ``{row: factor lengths}`` of
    the scalar rows (which take precedence over their words).
    """
    on_card = device_rows(lengths, factorization)
    scalar = scalar_rows(flat, starts, lengths, np.flatnonzero(~on_card), factorization, "wide")
    idx = np.flatnonzero(on_card)
    with trace("factor-words", windows=len(idx)):
        dev_lengths = to_device(lengths[idx], device)
        words, ok = factor_words(to_device(flat, device), to_device(starts[idx], device),
                                 dev_lengths, factorization)
        bad = idx[~to_host(ok)]
    scalar.update(scalar_rows(flat, starts, lengths, bad, factorization, "ok_false"))
    return idx, words, dev_lengths, scalar


def factor_lengths(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                   factorization: str, device) -> list[np.ndarray]:
    """Factor lengths of every window ``flat[starts[b] : starts[b] +
    lengths[b]]`` (see :func:`family_words`)."""
    idx, words, _, scalar = family_words(flat, starts, lengths, factorization, device)
    out: list[np.ndarray] = [np.zeros(0, np.int64)] * len(lengths)
    for b, ls in zip(idx, lengths_from_words(to_host(words), lengths[idx])):
        out[b] = ls
    for b, ls in scalar.items():
        out[b] = np.asarray(ls, np.int64)
    return out


def lengths_from_words(words: np.ndarray, n: np.ndarray) -> list[np.ndarray]:
    """Host decode of ``int32[B, W]`` start words: each row's gaps between
    consecutive starts, the last one up to ``n``."""
    B, W = words.shape
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8).reshape(B, 4 * W),
                         axis=1, bitorder="little").astype(bool)
    bits &= np.arange(32 * W)[None, :] < n[:, None]
    rows, pos = np.nonzero(bits)
    nxt = np.empty_like(pos)
    nxt[:-1] = pos[1:]
    last = np.ones(len(pos), bool)
    last[:-1] = rows[1:] != rows[:-1]
    nxt[last] = n[rows[last]]
    return np.split((nxt - pos).astype(np.int64), np.cumsum(bits.sum(axis=1))[:-1])


def factorize_batch(windows: Sequence[str], factorization: str, device) -> list[list[str]]:
    """Factorize a batch of strings on ``device``; returns factor strings
    (the host slices each string at its factor lengths)."""
    flat, starts, lengths, _ = window_stream(windows, shift=False)
    return [_slice(w, ls) for w, ls in
            zip(windows, factor_lengths(flat, starts, lengths, factorization, device))]


def _slice(w: str, lens) -> list[str]:
    out, pos = [], 0
    for n in lens:
        out.append(w[pos : pos + n])
        pos += int(n)
    return out


def fingerprint_reads(
    reads: Iterable[tuple[str, str]],
    factorization: str = "CFL",
    shift: bool = True,
    with_factors: bool = False,
    *,
    device,
) -> tuple[list[str], list[str]]:
    """Basic pipeline: fingerprint each read (or each of its shift windows).

    Returns ``(fingerprint_lines, factor_lines)`` formatted exactly like
    ``compute_fingerprint_by_list`` (fingerprint_utils.py:443-476): one line
    per window, ``ID len1 len2 ...``; ``factor_lines`` is empty unless
    ``with_factors``.
    """
    reads = list(reads)
    plan(factorization)  # an unknown family fails before any work
    flat, starts, lengths, counts = window_stream([s for _, s in reads], shift)
    lens = factor_lengths(flat, starts, lengths, factorization, device)
    fingerprint_lines, factor_lines = [], []
    b = 0
    for (rid, _), cnt in zip(reads, counts):
        for _ in range(cnt):
            fingerprint_lines.append(rid + " " + " ".join(map(str, lens[b].tolist())) + "\n")
            if with_factors:
                text = flat[starts[b] : starts[b] + lengths[b]].tobytes().decode("latin-1")
                factor_lines.append(rid + " " + " ".join(_slice(text, lens[b])) + "\n")
            b += 1
    return fingerprint_lines, factor_lines


def fingerprint_long_reads(
    reads: Iterable[tuple[str, str]],
    factorization: str = "CFL",
    split: int = 300,
    with_factors: bool = False,
    *,
    device,
) -> tuple[list[str], list[str]]:
    """Generalized pipeline: one line per read, chunk fingerprints joined
    with `` | `` (compute_long_fingerprint_by_list, :480-518).

    Keeps the reference's trailing separator: every line ends with
    ``... | `` before the newline.
    """
    reads = list(reads)
    ids, chunks, bounds = [], [], [0]
    for rid, seq in reads:
        cs = chunk_split(seq, split)
        ids.append(rid)
        chunks.extend(cs)
        bounds.append(bounds[-1] + len(cs))

    factor_lists = factorize_batch(chunks, factorization, device)
    fingerprint_lines, factor_lines = [], []
    for r, rid in enumerate(ids):
        fp_segments, fac_segments = [], []
        for factors in factor_lists[bounds[r] : bounds[r + 1]]:
            fp_segments.append(" ".join(str(len(f)) for f in factors))
            fac_segments.append(" ".join(factors))
        # the double space after the ID: the reference concatenates
        # "ID " + " " before the first segment (fingerprint_utils.py:494-495)
        fingerprint_lines.append(rid + "  " + " | ".join(fp_segments) + " | \n")
        if with_factors:
            factor_lines.append(rid + "  " + " | ".join(fac_segments) + " | \n")
    return fingerprint_lines, factor_lines


def run_basic(
    fasta_path: str,
    out_dir: str,
    factorization: str = "CFL",
    rev_com: bool = False,
    shift: bool = True,
    with_factors: bool = True,
    *,
    device,
) -> tuple[str, str | None]:
    """End-to-end basic pipeline: FASTA -> fingerprint_<FACT>.txt
    (+ fact_fingerprint_<FACT>.txt), as ``basic_fingerprint``
    (lyn2vec.py:14-93).  Returns the paths written."""
    reads = extract_reads(fasta_path, rev_com)
    if not reads:
        raise ValueError(f"no reads extracted from {fasta_path}")
    fp_lines, fac_lines = fingerprint_reads(
        reads, factorization, shift=shift, with_factors=with_factors, device=device
    )
    fp_path = os.path.join(out_dir, f"fingerprint_{factorization}.txt")
    with open(fp_path, "w") as fh:
        fh.writelines(fp_lines)
    fac_path = None
    if with_factors:
        fac_path = os.path.join(out_dir, f"fact_fingerprint_{factorization}.txt")
        with open(fac_path, "w") as fh:
            fh.writelines(fac_lines)
    return fp_path, fac_path
