"""Scalar (pure-Python) models: MurmurHash3, CFL factorization, statistics,
minmer selection.

Copies of the parts of :mod:`fpmash_tpu.scalar` the port needs.  They are
the independent oracle the kernels are held against where the JAX package
cannot be imported (on the machine with the card).
"""
