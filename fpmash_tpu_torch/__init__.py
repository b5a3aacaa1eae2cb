"""fpmash_tpu_torch — the fp-mash sketch-and-distance pipeline on PyTorch + CUDA.

A port of :mod:`fpmash_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Host glue (CLI, FASTA and ``.msh`` IO, statistics) is plain Python and
numpy; batched compute is PyTorch on an explicit ``device``; every Pallas
kernel of the JAX package becomes a CUDA C++ kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``).  The
host helpers of ``native/`` (the FASTA/FASTQ and fingerprint-file readers,
the host factorizer; copies of the JAX package's C++) are built with ``g++``
at first use the same way.

The package imports ``torch``, ``numpy`` and the standard library, never
``jax`` or :mod:`fpmash_tpu` (whose ``__init__`` imports JAX), so it runs
where JAX is not installed.  Host modules it needs are carried as copies.

Every verb of the JAX package's CLI is ported: the fingerprint path
(``sketch --direct-fp`` under all ten lyn2vec factorization families,
``sketch -fp``, ``dist -fp``, the ``fingerprint`` verb), the classic k-mer
MinHash path (``sketch``, ``dist``, ``triangle``, ``screen``), windowed
sketches (``sketch -W``) and ``find``, and the host verbs (``contain``,
``paste``, ``info``, ``bounds``, ``taxscreen``, ``generate``,
``mapping``); so are all fifteen Pallas kernels, the five that the JAX
package keeps off its routes behind the entry points of the JAX functions
that reach them.
"""

__version__ = "0.1.0"
