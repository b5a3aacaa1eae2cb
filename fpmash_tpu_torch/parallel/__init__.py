"""Data parallelism over several devices: meshes and sharded routes.

Counterpart of :mod:`fpmash_tpu.parallel`.  One process runs every shard:
shard ``i`` of a mesh runs on the ``i``-th ``torch.device`` of the mesh, on
that device's current stream, and the results are gathered in shard order
on the mesh's first device (or on the host), where the JAX package runs
``shard_map`` over a ``jax.sharding.Mesh`` and gathers with collectives.
"""
