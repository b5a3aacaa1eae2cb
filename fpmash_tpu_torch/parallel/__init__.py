"""Data parallelism over several devices: the sharded routes.

Counterpart of :mod:`fpmash_tpu.parallel`.  One process runs every shard:
shard ``i`` of a mesh (a tuple of ``torch.device``, as
``device.resolve_devices`` gives) runs on the ``i``-th device of the mesh, on
that device's current stream, and the results are gathered in shard order
on the mesh's first device (or on the host), where the JAX package runs
``shard_map`` over a ``jax.sharding.Mesh`` and gathers with collectives.
"""
