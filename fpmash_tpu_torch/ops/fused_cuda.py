"""Per-window CFL factorization + MurmurHash3: kernel K1, its plain version, its wrapper.

Counterpart of ``fpmash_tpu/ops/fused_pallas.py`` (Pallas ``_split_kernel``
behind ``fingerprint_hashes_fused`` and ``fingerprint_hashes_fused_words``).
For each window it returns ``(h1, h2, count)``: MurmurHash3_x64_128 of the
window's Duval factor-length vector (as u64 values) and the factor count.

Windows are given as ``(starts, lengths)`` into one flat byte stream, which
replaces both of the JAX package's layouts (u8 window rows, and the dna16
words gathered by ``dna16_window_words``): overlapping shift windows share
the stream, and every byte value is allowed.  A window that does not lie
inside the stream gets ``count = -1`` and zero hashes.

:func:`fingerprint_hashes` launches the CUDA kernel (``csrc/fingerprint.cu``)
for tensors on a CUDA device and runs :func:`fingerprint_hashes_plain` for
tensors on the CPU.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0


def check_stream(flat, starts, lengths):
    """Raise unless ``(flat, starts, lengths)`` is a window stream: contiguous
    ``uint8[N]``, ``int64[B]`` and ``int32[B]`` on one device."""
    if flat.dim() != 1 or flat.dtype != torch.uint8 or not flat.is_contiguous():
        raise ValueError(f"flat must be contiguous uint8 [N], got {flat.dtype} {tuple(flat.shape)}")
    if starts.dim() != 1 or starts.dtype != torch.int64 or not starts.is_contiguous():
        raise ValueError(f"starts must be contiguous int64 [B], got {starts.dtype} {tuple(starts.shape)}")
    if lengths.shape != starts.shape or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(
            f"lengths must be contiguous int32 {tuple(starts.shape)}, "
            f"got {lengths.dtype} {tuple(lengths.shape)}"
        )
    if not (flat.device == starts.device == lengths.device):
        raise ValueError(
            f"inputs on different devices: {flat.device}, {starts.device}, {lengths.device}"
        )


def fingerprint_hashes(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                       seed: int = 42):
    """``(h1 int64[B], h2 int64[B], count int32[B])`` for windows
    ``flat[starts[b] : starts[b] + lengths[b]]`` of the ``uint8`` stream."""
    global LAUNCHES
    check_stream(flat, starts, lengths)
    dev = flat.device
    if dev.type == "cpu":
        return fingerprint_hashes_plain(flat, starts, lengths, seed)
    if dev.type != "cuda":
        raise ValueError(f"fingerprint_hashes runs on cpu or cuda tensors, not {dev}")
    from fpmash_tpu_torch.ops._build import check, library

    B = starts.numel()
    h1 = torch.empty(B, dtype=torch.int64, device=dev)
    h2 = torch.empty(B, dtype=torch.int64, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return h1, h2, count
    with torch.cuda.device(dev):
        code = library().fpmash_fingerprint(
            flat.data_ptr(), flat.numel(), starts.data_ptr(), lengths.data_ptr(), B,
            seed & ((1 << 64) - 1), h1.data_ptr(), h2.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "fingerprint kernel launch")
    LAUNCHES += 1
    return h1, h2, count


def fingerprint_hashes_plain(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                             seed: int = 42):
    """Plain PyTorch version of the kernel, on any device: the Duval
    factor-start words of ``ops/icfl_cuda.factor_words_plain`` (all windows
    stepping in lockstep), hashed by ``hash_words_plain``."""
    from fpmash_tpu_torch.ops.icfl_cuda import factor_words_plain, hash_words_plain

    check_stream(flat, starts, lengths)
    words, inside = factor_words_plain(flat, starts, lengths, "CFL")
    h1, h2, count = hash_words_plain(words, torch.where(inside, lengths, 0), seed)
    return (torch.where(inside, h1, 0), torch.where(inside, h2, 0),
            torch.where(inside, count, -1))
