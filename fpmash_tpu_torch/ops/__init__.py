"""Batched compute on tensors: plain PyTorch and the CUDA kernel wrappers.

Each kernel module holds the kernel's wrapper, its plain PyTorch version and
a launch count.  A wrapper runs the plain version for tensors on the CPU and
launches its kernel for tensors on a CUDA device; it never falls back from
one to the other.
"""
