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

from fpmash_tpu_torch.ops.murmur3 import murmur3_u64_batch

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0


def _check(flat, starts, lengths):
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
    _check(flat, starts, lengths)
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
    """Plain PyTorch version of the kernel, on any device.

    Runs Duval's automaton for all windows in lockstep as ``[B]`` vectors
    (one state step per iteration: extend the scan, emit a factor, or start
    the next scan), scatters each emitted factor length into a ``[B, Lmax]``
    matrix, then hashes the matrix with :func:`murmur3_u64_batch`.
    """
    _check(flat, starts, lengths)
    dev = flat.device
    B, N = starts.numel(), flat.numel()
    n = lengths.to(torch.int64)
    ok = (starts >= 0) & (n >= 0) & (starts <= N - n)
    n = torch.where(ok, n, 0)
    st = torch.where(ok, starts, 0)
    width = int(n.max()) if B else 0

    # column `width` is a dump slot for rows that emit nothing this step
    lens = torch.zeros((B, width + 1), dtype=torch.int64, device=dev)
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    i = torch.zeros(B, dtype=torch.int64, device=dev)
    j = torch.ones(B, dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    emitting = torch.zeros(B, dtype=torch.bool, device=dev)
    chars = flat.to(torch.int16)
    last = max(N - 1, 0)
    while width:
        done = i >= n
        if bool(done.all()):
            break
        s_k = chars[(st + k).clamp(0, last)]
        s_j = chars[(st + torch.minimum(j, n - 1)).clamp(0, last)]
        scanning = ~emitting & ~done
        extend = scanning & (j < n) & (s_k <= s_j)
        emit_now = i <= k
        fire = emitting & ~done & emit_now
        reset = emitting & ~done & ~emit_now
        p = j - k
        lens.scatter_(1, torch.where(fire, cnt, width)[:, None], p[:, None])
        cnt = cnt + fire
        k = torch.where(extend, torch.where(s_k < s_j, i, k + 1), k)
        j = torch.where(extend, j + 1, j)
        i = torch.where(fire, i + p, i)
        j = torch.where(reset, i + 1, j)
        k = torch.where(reset, i, k)
        emitting = (emitting | (scanning & ~extend)) & ~reset

    h1, h2 = murmur3_u64_batch(lens[:, :width], cnt, seed)
    h1 = torch.where(ok, h1, 0)
    h2 = torch.where(ok, h2, 0)
    count = torch.where(ok, cnt, -1).to(torch.int32)
    return h1, h2, count
