"""Order-dependent merge-join walk: kernel K2, its plain version, its wrapper.

Counterpart of ``fpmash_tpu/ops/walk_pallas.py`` (Pallas ``_walk_kernel``
behind ``pairwise_walk_pallas``).  For every (reference, query) pair it runs
the literal capped merge-join of CommandDistance.cpp:376-400 over the two
hash lists in their stored order and returns ``common`` and ``denom``.

Lists are ``int64 [R, S]`` holding u64 hash bits (see ``ops/murmur3.py``),
compared as unsigned, with their lengths in ``int32 [R]``; lengths are
clamped to ``[0, S]``.  :func:`pairwise_walk` launches the CUDA kernel
(``csrc/walk.cu``) for tensors on a CUDA device and runs
:func:`pairwise_walk_plain` for tensors on the CPU.  ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.murmur3 import ult

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0


def _check(ref, ref_len, qry, qry_len):
    for name, lists, lens in (("ref", ref, ref_len), ("qry", qry, qry_len)):
        if lists.dim() != 2 or lists.dtype != torch.int64 or not lists.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous int64 [n, S], got {lists.dtype} {tuple(lists.shape)}"
            )
        if lens.shape != lists.shape[:1] or lens.dtype != torch.int32 or not lens.is_contiguous():
            raise ValueError(
                f"{name}_len must be contiguous int32 [{lists.shape[0]}], "
                f"got {lens.dtype} {tuple(lens.shape)}"
            )
    if len({ref.device, ref_len.device, qry.device, qry_len.device}) != 1:
        raise ValueError("walk inputs lie on different devices")


def pairwise_walk(ref: torch.Tensor, ref_len: torch.Tensor, qry: torch.Tensor,
                  qry_len: torch.Tensor, sketch_size: int):
    """``(common int32[R, Q], denom int32[R, Q])`` of the literal capped walk."""
    global LAUNCHES
    _check(ref, ref_len, qry, qry_len)
    dev = ref.device
    if dev.type == "cpu":
        return pairwise_walk_plain(ref, ref_len, qry, qry_len, sketch_size)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_walk runs on cpu or cuda tensors, not {dev}")
    from fpmash_tpu_torch.ops._build import check, library

    (R, S1), (Q, S2) = ref.shape, qry.shape
    common = torch.empty((R, Q), dtype=torch.int32, device=dev)
    denom = torch.empty((R, Q), dtype=torch.int32, device=dev)
    if R == 0 or Q == 0:
        return common, denom
    with torch.cuda.device(dev):
        code = library().fpmash_walk(
            ref.data_ptr(), ref_len.data_ptr(), R, S1,
            qry.data_ptr(), qry_len.data_ptr(), Q, S2,
            # a cap beyond int32 caps nothing: lists are shorter than 2^31
            min(int(sketch_size), 2**31 - 1), common.data_ptr(), denom.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "walk kernel launch")
    LAUNCHES += 1
    return common, denom


def pairwise_walk_plain(ref: torch.Tensor, ref_len: torch.Tensor, qry: torch.Tensor,
                        qry_len: torch.Tensor, sketch_size: int):
    """Plain PyTorch version, on any device: every pair's ``(i, j, common,
    denom)`` steps in lockstep as ``[R*Q]`` vectors, two flat gathers per
    step (the XLA walk of ``fpmash_tpu/ops/walk.py:32``)."""
    _check(ref, ref_len, qry, qry_len)
    dev = ref.device
    (R, S1), (Q, S2) = ref.shape, qry.shape
    r_idx = torch.arange(R, device=dev).repeat_interleave(Q)
    q_idx = torch.arange(Q, device=dev).repeat(R)
    la = ref_len.to(torch.int64).clamp(0, S1)[r_idx]
    lb = qry_len.to(torch.int64).clamp(0, S2)[q_idx]
    ref_flat, qry_flat = ref.reshape(-1), qry.reshape(-1)
    rbase, qbase = r_idx * S1, q_idx * S2

    i = torch.zeros(R * Q, dtype=torch.int64, device=dev)
    j, common, denom = torch.zeros_like(i), torch.zeros_like(i), torch.zeros_like(i)
    # every step consumes an element, so a walk ends within min(s, S1 + S2)
    steps = min(sketch_size, S1 + S2) if S1 and S2 else 0
    for _ in range(steps):
        live = (denom < sketch_size) & (i < la) & (j < lb)
        if not bool(live.any()):
            break
        a = ref_flat[(rbase + i).clamp(max=R * S1 - 1)]
        b = qry_flat[(qbase + j).clamp(max=Q * S2 - 1)]
        lt, gt = ult(a, b), ult(b, a)
        i = i + (live & ~gt)
        j = j + (live & ~lt)
        common = common + (live & ~lt & ~gt)
        denom = denom + live

    # post-loop fix-up (CommandDistance.cpp:392-400)
    short = denom < sketch_size
    denom = torch.where(short, (denom + (la - i) + (lb - j)).clamp(max=sketch_size), denom)
    return (
        common.to(torch.int32).reshape(R, Q),
        denom.to(torch.int32).reshape(R, Q),
    )
