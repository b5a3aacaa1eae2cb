"""Per-window CFL factorization + MurmurHash3: kernels K1 and K13, plain versions, wrappers.

Counterpart of ``fpmash_tpu/ops/fused_pallas.py`` (Pallas ``_split_kernel``,
K1, and ``_fused_kernel``, K13, behind ``fingerprint_hashes_fused`` and
``fingerprint_hashes_fused_words``).  For each window they return ``(h1,
h2, count)``: MurmurHash3_x64_128 of the window's Duval factor-length vector
(as u64 values) and the factor count.

Windows are given as ``(starts, lengths)`` into one flat byte stream, which
replaces both of the JAX package's layouts (u8 window rows, and the dna16
words gathered by ``dna16_window_words``): overlapping shift windows share
the stream, and every byte value is allowed.  A window that does not lie
inside the stream gets ``count = -1`` and zero hashes.

:func:`fingerprint_hashes` launches the CUDA kernel (``csrc/fingerprint.cu``)
for tensors on a CUDA device and runs :func:`fingerprint_hashes_plain` for
tensors on the CPU.  ``LAUNCHES`` counts the kernel's launches.

:func:`fingerprint_hashes_fused` is the JAX function's own entry point, with
its signature: ``u8 [B, L]`` rows and their lengths, ``pack`` (``byte4``
compares raw bytes; ``dna16`` compares C, G, T as 1, 2, 3 and every other
byte as 0, so an ``N`` compares like an ``A``) and ``variant``:
``"split"`` ships the rows as a window stream to K1, ``"inline"`` launches
K13, which reads the rows in place (``csrc/fingerprint.cu``, one body for
both: a block's rows are staged once, dna16 mapped at staging).
``INLINE_LAUNCHES`` counts K13's launches.
"""

from __future__ import annotations

import torch

#: kernel launches in this process (the plain versions do not count): K1, K13
LAUNCHES = 0
INLINE_LAUNCHES = 0

PACKS = {"byte4": 0, "dna16": 1}


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


def _check_rows(batch, lengths, pack: str, variant: str):
    if batch.dim() != 2 or batch.dtype != torch.uint8 or not batch.is_contiguous():
        raise ValueError(f"batch must be contiguous uint8 [B, L], got {batch.dtype} "
                         f"{tuple(batch.shape)}")
    if lengths.shape != batch.shape[:1] or lengths.is_floating_point() or lengths.is_complex():
        raise ValueError(f"lengths must be integers [{batch.shape[0]}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if lengths.device != batch.device:
        raise ValueError(f"inputs on different devices: {batch.device}, {lengths.device}")
    if batch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fingerprint_hashes_fused runs on cpu or cuda tensors, not {batch.device}")
    if pack not in PACKS:
        raise ValueError(f"unknown pack mode {pack!r}")
    if variant not in ("split", "inline"):
        raise ValueError(f"unknown variant {variant!r}")
    if lengths.numel():
        lo, hi = torch.stack(torch.aminmax(lengths)).tolist()  # one wait for the card
        if not 0 <= lo <= hi <= batch.shape[1]:
            raise ValueError(f"lengths must lie in [0, {batch.shape[1]}]")


def _packed_rows(batch, pack: str):
    """The rows as the kernel compares them: raw bytes, or the dna16 codes."""
    if pack == "byte4":
        return batch
    codes = torch.zeros_like(batch)
    for v, ch in enumerate(b"CGT", 1):
        codes[batch == ch] = v
    return codes


def fingerprint_hashes_fused(batch: torch.Tensor, lengths: torch.Tensor, seed: int = 42,
                             pack: str = "byte4", variant: str = "split"):
    """``(h1 int64[B], h2 int64[B], count int32[B])`` of rows
    ``batch[b, :lengths[b]]`` (lengths in ``[0, L]``), as the JAX function of
    this name computes them under ``pack``: K1 on the rows' stream
    (``variant="split"``) or K13 on the rows (``"inline"``); both variants
    answer alike.  The plain version for tensors on the CPU."""
    global INLINE_LAUNCHES
    _check_rows(batch, lengths, pack, variant)
    lengths = lengths.to(torch.int32).contiguous()
    dev = batch.device
    if dev.type == "cpu":
        return fingerprint_hashes_fused_plain(batch, lengths, seed, pack)
    B, L = batch.shape
    if variant == "split":
        starts = torch.arange(B, dtype=torch.int64, device=dev) * L
        return fingerprint_hashes(_packed_rows(batch, pack).reshape(-1), starts, lengths, seed)
    from fpmash_tpu_torch.ops._build import check, library

    h1 = torch.empty(B, dtype=torch.int64, device=dev)
    h2 = torch.empty(B, dtype=torch.int64, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return h1, h2, count
    with torch.cuda.device(dev):
        code = library().fpmash_fingerprint_rows(
            batch.data_ptr(), B, L, lengths.data_ptr(), PACKS[pack], seed & ((1 << 64) - 1),
            h1.data_ptr(), h2.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "fingerprint rows kernel launch")
    INLINE_LAUNCHES += 1
    return h1, h2, count


def fingerprint_hashes_fused_plain(batch: torch.Tensor, lengths: torch.Tensor, seed: int = 42,
                                   pack: str = "byte4"):
    """Plain version of :func:`fingerprint_hashes_fused` (either variant), on
    any device: :func:`fingerprint_hashes_plain` of the packed rows' stream."""
    _check_rows(batch, lengths, pack, "split")
    B, L = batch.shape
    starts = torch.arange(B, dtype=torch.int64, device=batch.device) * L
    return fingerprint_hashes_plain(_packed_rows(batch, pack).reshape(-1), starts,
                                    lengths.to(torch.int32).contiguous(), seed)
