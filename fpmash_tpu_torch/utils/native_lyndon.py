"""ctypes bindings of the native factorizer (port of :mod:`fpmash_tpu.utils.native_lyndon`).

``native/lyndon.cpp`` (a copy of the JAX package's) factorizes whole
batches of strings on the host under any of the ten families, giving the
scalar models' factor lengths (``scalar/lyndon.py``, ``<<``/``>>`` markers
stripped).  The port sends it the rows it keeps off the card
(``models/fingerprint.scalar_rows``).  Built with ``g++`` at first use into
``build/`` (:func:`fpmash_tpu_torch.ops._build.host_library`); a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from fpmash_tpu_torch.ops import _build

#: family -> (the C function's ``alg_id``, its threshold ``T``)
ALG_IDS = {
    "CFL": (0, 0),
    "ICFL": (1, 0),
    "CFL_ICFL-10": (2, 10),
    "CFL_ICFL-20": (2, 20),
    "CFL_ICFL-30": (2, 30),
    "CFL_COMB": (3, 0),
    "ICFL_COMB": (4, 0),
    "CFL_ICFL_COMB-10": (5, 10),
    "CFL_ICFL_COMB-20": (5, 20),
    "CFL_ICFL_COMB-30": (5, 30),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.host_library("lyndon")
    lib.lyn_factorize_batch.restype = ctypes.c_long
    # blob, offsets, n_rows, alg_id, T, out_lens, cap, out_offsets
    lib.lyn_factorize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (``g++`` or ``$CXX``)."""
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def factorize_flat(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                   factorization: str) -> tuple[np.ndarray, np.ndarray]:
    """Factor lengths of the rows ``flat[starts[b] : starts[b] + lengths[b]]``
    (``flat`` uint8; rows may overlap, as shift windows do).

    Returns ``(lens int32[F], offsets int64[B + 1])``: row ``b``'s factor
    lengths are ``lens[offsets[b] : offsets[b + 1]]``; an empty row has none.
    """
    if factorization not in ALG_IDS:
        raise ValueError(f"unknown factorization {factorization!r}; "
                         f"expected one of {sorted(ALG_IDS)}")
    alg_id, T = ALG_IDS[factorization]
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    if starts.shape != lengths.shape or starts.ndim != 1:
        raise ValueError(f"starts {starts.shape} and lengths {lengths.shape} must be one "
                         "array each of the same length")
    if len(lengths) and (lengths.min() < 0 or starts.min() < 0
                         or (starts + lengths).max() > len(flat)):
        raise ValueError(f"rows must lie inside the stream of {len(flat)} bytes")
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    if len(lengths) and np.array_equal(starts[1:], starts[:-1] + lengths[:-1]):
        blob = flat[starts[0] : starts[0] + offsets[-1]]  # rows back to back: no copy
    else:
        # each row's bytes back to back: row b's position j reads starts[b] + j
        idx = np.arange(offsets[-1], dtype=np.int64)
        blob = flat[idx + np.repeat(starts - offsets[:-1], lengths)]
    blob = np.ascontiguousarray(blob, np.uint8)
    cap = int(offsets[-1]) + len(lengths)  # a factor is at least one character long
    out_lens = np.zeros(max(cap, 1), np.int32)
    out_offsets = np.zeros(len(lengths) + 1, np.int64)
    total = _lib().lyn_factorize_batch(blob.ctypes.data, offsets.ctypes.data, len(lengths),
                                       alg_id, T, out_lens.ctypes.data, cap,
                                       out_offsets.ctypes.data)
    if total < 0:
        raise RuntimeError(f"lyn_factorize_batch({factorization}) returned {total}")
    return out_lens[:total], out_offsets


def factorize_batch_native(windows: list[str], factorization: str) -> list[list[int]]:
    """Factor-length lists of each string of ``windows`` (the JAX module's
    entry point; each string encoded as ASCII, other characters ``?``)."""
    data = [w.encode("ascii", "replace") for w in windows]
    lengths = np.array([len(d) for d in data], np.int64)
    starts = np.zeros(len(data), np.int64)
    if len(data):
        np.cumsum(lengths[:-1], out=starts[1:])
    flat = np.frombuffer(b"".join(data), np.uint8)
    lens, offsets = factorize_flat(flat, starts, lengths, factorization)
    return [lens[offsets[b] : offsets[b + 1]].tolist() for b in range(len(windows))]
