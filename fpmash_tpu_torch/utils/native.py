"""ctypes bindings of the native IO library (port of :mod:`fpmash_tpu.utils.native`).

``native/fpio.cpp`` (a copy of the JAX package's) holds the batch parsers
that replace the reference's C++ host-side parsing: a kseq-style
FASTA/FASTQ reader and ``Sketch::initFromFingerprints``' line parser.  They
return flat numpy arrays.  The library is built with ``g++`` at first use
into ``build/`` (:func:`fpmash_tpu_torch.ops._build.host_library`); a
failed build raises with the compiler's message, and nothing falls back to
the Python readers.  :func:`parse_seq_file` reads every plain FASTA/FASTQ
file of the port (:func:`fpmash_tpu_torch.utils.fasta.read_sequences`), as
the JAX CLI reads them; :func:`parse_fingerprint_file` is bound and tested,
and no route uses it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from fpmash_tpu_torch.ops import _build

_p, _long = ctypes.c_void_p, ctypes.c_long
_u64p, _charp = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_char)
_SIGNATURES = {
    # name: (restype, argtypes)
    "fpio_parse_fingerprint": (_p, [ctypes.c_char_p, _long]),
    "fpio_fingerprint_n_lines": (_long, [_p]),
    "fpio_fingerprint_n_values": (_long, [_p]),
    "fpio_fingerprint_values": (_u64p, [_p]),
    "fpio_fingerprint_line_offsets": (_u64p, [_p]),
    "fpio_fingerprint_ids": (_charp, [_p]),
    "fpio_fingerprint_ids_size": (_long, [_p]),
    "fpio_fingerprint_free": (None, [_p]),
    "fpio_parse_seq": (_p, [ctypes.c_char_p]),
    "fpio_seq_n_records": (_long, [_p]),
    "fpio_seq_data": (_charp, [_p]),
    "fpio_seq_data_size": (_long, [_p]),
    "fpio_seq_offsets": (_u64p, [_p]),
    "fpio_seq_names": (_charp, [_p]),
    "fpio_seq_names_size": (_long, [_p]),
    "fpio_seq_comments": (_charp, [_p]),
    "fpio_seq_comments_size": (_long, [_p]),
    "fpio_seq_free": (None, [_p]),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.host_library("fpio")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the library builds and loads here (``g++`` or ``$CXX``)."""
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def _open(path: str, parse, *args):
    """The parser's handle of ``path``; raises as ``open`` would where the
    C reader cannot (a missing file, a directory)."""
    if os.path.isdir(path):
        raise IsADirectoryError(path)
    h = parse(os.fsencode(path), *args)
    if not h:
        raise FileNotFoundError(path)
    return h


def _strings(ptr, size: int) -> list[str]:
    blob = ctypes.string_at(ptr, size)
    return blob.decode("utf-8", "replace").split("\0")[:-1] if blob else []


def parse_fingerprint_file(path: str, max_lines: int = 0):
    """Parse a fingerprint ``.txt``: ``(ids, values, offsets)``, ``ids`` the
    per-line ID strings, ``values`` a flat u64 array, ``values[offsets[i] :
    offsets[i + 1]]`` line i's.  ``max_lines <= 0``: every line."""
    lib = _lib()
    h = _open(path, lib.fpio_parse_fingerprint, max_lines)
    try:
        n = lib.fpio_fingerprint_n_lines(h)
        nv = lib.fpio_fingerprint_n_values(h)
        values = (np.ctypeslib.as_array(lib.fpio_fingerprint_values(h), shape=(nv,)).copy()
                  if nv else np.zeros(0, np.uint64))
        offsets = np.ctypeslib.as_array(lib.fpio_fingerprint_line_offsets(h), shape=(n + 1,))
        ids = _strings(lib.fpio_fingerprint_ids(h), lib.fpio_fingerprint_ids_size(h))
        return ids, values.astype(np.uint64), offsets.astype(np.int64)
    finally:
        lib.fpio_fingerprint_free(h)


def parse_seq_file(path: str):
    """Parse a plain (not gzipped) FASTA/FASTQ file: ``(names, comments,
    blob, offsets)``, ``blob`` the concatenated sequence bytes and
    ``blob[offsets[i] : offsets[i + 1]]`` record i's."""
    if path == "-" or path.endswith(".gz"):
        raise ValueError(f"{path}: the native reader takes plain files only")
    lib = _lib()
    h = _open(path, lib.fpio_parse_seq)
    try:
        n = lib.fpio_seq_n_records(h)
        blob = ctypes.string_at(lib.fpio_seq_data(h), lib.fpio_seq_data_size(h))
        offsets = np.ctypeslib.as_array(lib.fpio_seq_offsets(h), shape=(n + 1,))
        names = _strings(lib.fpio_seq_names(h), lib.fpio_seq_names_size(h))
        comments = _strings(lib.fpio_seq_comments(h), lib.fpio_seq_comments_size(h))
        return names, comments, blob, offsets.astype(np.int64)
    finally:
        lib.fpio_seq_free(h)
