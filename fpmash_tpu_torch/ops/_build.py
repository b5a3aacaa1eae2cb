"""Build the CUDA kernels of ``csrc/`` at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together; headers ``csrc/*.cuh``) for Hopper (``sm_90a``) and links them into
one shared library with a plain C interface, in ``build/`` at the repository
root.  The library's name carries a digest of the sources and flags, so an
edited source builds anew and a finished build is reused by later
processes.  Nothing is built or loaded when this module is imported.

Each C entry point returns the ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code, because a refused launch never runs
and a later synchronise would not report it.

:func:`host_library` builds the host helpers of ``native/*.cpp`` (the
FASTA/FASTQ and fingerprint-file readers, the host factorizer) the same way
with ``g++`` (or ``$CXX``): one ``build/lib<name>_<digest>.so`` a source,
built at first use, no card or ``nvcc`` needed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

from fpmash_tpu_torch.utils.trace import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
HOST_SRC = _PKG / "native"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_p, _i32, _i64, _u64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
_u32 = ctypes.c_uint32
_SIGNATURES = {
    # seq, n, k, flags, seed, lo, hi, valid, stream
    "fpmash_kmer_hashes": [_p, _i64, _i32, _i32, _u64, _p, _p, _p, _p],
    # seq, n, length, k, flags, seed, t_hi, lo, hi, stream
    "fpmash_kmer_hashes_masked": [_p, _i64, _i64, _i32, _i32, _u64, _u32, _p, _p, _p],
    # seq, n, length, k, flags, seed, t_hi, clo, chi, overflow, stream
    "fpmash_kmer_hashes_topk8": [_p, _i64, _i64, _i32, _i32, _u64, _u32, _p, _p, _p, _p],
    # codes, n, length, k, flags, seed, t_hi, clo, chi, overflow, stream
    "fpmash_kmer_codes_topk": [_p, _i64, _i64, _i32, _i32, _u64, _u32, _p, _p, _p, _p],
    # codes, n, k, flags, seed, lo, hi, valid, stream
    "fpmash_kmer_codes_hashes": [_p, _i64, _i32, _i32, _u64, _p, _p, _p, _p],
    # F, R, n, k, flags, seed, h1, stream
    "fpmash_canonical_murmur": [_p, _p, _i64, _i32, _i32, _u64, _p, _p],
    # flat, n_flat, starts, lengths, n_windows, seed, h1, h2, count, stream
    "fpmash_fingerprint": [_p, _i64, _p, _p, _i64, _u64, _p, _p, _p, _p],
    # rows, n_rows, width, lengths, pack, seed, h1, h2, count, stream
    "fpmash_fingerprint_rows": [_p, _i64, _i32, _p, _i32, _u64, _p, _p, _p, _p],
    # keys, payload, n_rows, out_keys, out_payload, stream
    "fpmash_row_sort": [_p, _p, _i64, _p, _p, _p],
    # ref, ref_len, n_ref, ref_stride, qry, qry_len, n_qry, qry_stride,
    # sketch_size, common, denom, stream
    "fpmash_walk": [_p, _p, _i64, _i64, _p, _p, _i64, _i64, _i32, _p, _p, _p],
    # the same arguments as fpmash_walk, over lists sorted ascending
    "fpmash_compare": [_p, _p, _i64, _i64, _p, _p, _i64, _i64, _i32, _p, _p, _p],
    # flat, n_flat, starts, lengths, n_windows, base, threshold, comb, max_len,
    # words, n_words, ok, stream
    "fpmash_factor_words": [_p, _i64, _p, _p, _i64, _i32, _i32, _i32, _i32, _p, _i32, _p, _p],
    # words, n_words, lengths, n_rows, seed, h1, h2, count, stream
    "fpmash_hash_words": [_p, _i32, _p, _i64, _u64, _p, _p, _p, _p],
    # h, prev, n, ws, mins, tile, tile0, n_tiles, threads, starts, cap,
    # stage, scratch_idx, scratch_flag, scratch_cap, marks, stream
    "fpmash_winnow": [_p, _p, _i64, _i64, _i32, _i64, _i64, _i64, _i32, _i32, _i32, _i32, _p,
                      _p, _i64, _p, _p],
    # data, n, tile_nl, stream
    "fpmash_seq_newlines": [_p, _i64, _p, _p],
    # data, n, tile_nl, n_lines, line_start, meta, seq_len, blk, out_off, starts, k, stream
    "fpmash_seq_lines": [_p, _i64, _p, _i64, _p, _p, _p, _p, _p, _p, _i32, _p],
    # data, n, tile_nl, line_start, seq_len, out_off, starts, meta, k, out, lengths, stream
    "fpmash_seq_copy": [_p, _i64, _p, _p, _p, _p, _p, _p, _i32, _p, _p, _p],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path() -> Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfpmash_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    results = [(cmd, proc.communicate()[1], proc.returncode) for cmd, proc in procs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    if all(code == 0 for _, _, code in results):
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        results.append((cmd, link.stderr, link.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, err, code in results:
        if code != 0:
            raise RuntimeError(f"nvcc failed (exit {code}): {' '.join(cmd)}\n{err}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process
    (span ``kernel-load``, ``built`` true where ``nvcc`` ran)."""
    with trace("kernel-load", lib="fpmash_kernels", built=not library_path().exists()):
        lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fpmash_error_string.argtypes = [ctypes.c_int]
    lib.fpmash_error_string.restype = ctypes.c_char_p
    return lib


def _cxx() -> list[str]:
    return shlex.split(os.environ.get("CXX") or "g++")


def host_library_path(name: str) -> Path:
    """Where :func:`host_library` puts ``native/<name>.cpp``'s build: the
    name carries a digest of the source, the compiler and the flags."""
    digest = hashlib.sha256(" ".join([*_cxx(), *HOST_FLAGS]).encode())
    digest.update((HOST_SRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """``native/<name>.cpp`` compiled with ``g++`` (or ``$CXX``) into
    ``build/`` unless this exact build exists, then loaded.  A failed build
    raises with the compiler's standard error; nothing falls back.  Span
    ``kernel-load``, ``built`` true where the compiler ran."""
    out = host_library_path(name)
    built = not out.exists()
    with trace("kernel-load", lib=name, built=built):
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.{threading.get_ident()}.so.tmp"
            cmd = [*_cxx(), *HOST_FLAGS, "-o", str(tmp), str(HOST_SRC / f"{name}.cpp")]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:  # no such compiler
                raise RuntimeError(f"host build failed: {' '.join(cmd)}: {exc}") from exc
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host build failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builds never see half a file
        return ctypes.CDLL(str(out))


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().fpmash_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
