"""Sorted all-pairs comparison: kernel K9's wrapper and launch count.

Counterpart of ``fpmash_tpu/ops/compare_pallas.py`` (Pallas
``_compare_kernel`` behind ``pairwise_common_denom_pallas``).  For every
(reference, query) pair it merges the two lists' live elements and returns
``common`` and ``denom`` of the capped union, as defined in
``ops/compare.py``.

Lists are ``int64 [R, S]`` holding u64 hash bits, **sorted ascending as
unsigned values** within each length, with their lengths in ``int32 [R]``;
lengths are clamped to ``[0, S]``.  :func:`pairwise_common_denom` launches the
CUDA kernel (``csrc/compare.cu``) for tensors on a CUDA device and runs the
plain version :func:`~fpmash_tpu_torch.ops.compare.pairwise_common_denom`
(which also takes unsorted lists) for tensors on the CPU.  ``LAUNCHES``
counts the kernel's launches.
"""

from __future__ import annotations

import torch

from fpmash_tpu_torch.ops.compare import pairwise_common_denom as pairwise_common_denom_plain
from fpmash_tpu_torch.ops.walk_cuda import _check

#: kernel launches in this process (the plain version does not count)
LAUNCHES = 0


def pairwise_common_denom(ref: torch.Tensor, ref_len: torch.Tensor, qry: torch.Tensor,
                          qry_len: torch.Tensor, sketch_size: int):
    """``(common int32[R, Q], denom int32[R, Q])`` of the capped union merge."""
    global LAUNCHES
    _check(ref, ref_len, qry, qry_len)
    dev = ref.device
    if dev.type == "cpu":
        return pairwise_common_denom_plain(ref, ref_len, qry, qry_len, sketch_size)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_common_denom runs on cpu or cuda tensors, not {dev}")
    from fpmash_tpu_torch.ops._build import check, library

    (R, S1), (Q, S2) = ref.shape, qry.shape
    common = torch.empty((R, Q), dtype=torch.int32, device=dev)
    denom = torch.empty((R, Q), dtype=torch.int32, device=dev)
    if R == 0 or Q == 0:
        return common, denom
    with torch.cuda.device(dev):
        code = library().fpmash_compare(
            ref.data_ptr(), ref_len.data_ptr(), R, S1,
            qry.data_ptr(), qry_len.data_ptr(), Q, S2,
            # a cap beyond int32 caps nothing: lists are shorter than 2^31
            min(int(sketch_size), 2**31 - 1), common.data_ptr(), denom.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code, "compare kernel launch")
    LAUNCHES += 1
    return common, denom
