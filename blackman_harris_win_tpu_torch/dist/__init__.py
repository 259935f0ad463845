"""The distribution layer, in one process (counterpart of
``blackman_harris_win_tpu/dist/``).

The JAX package runs its sharded steps as single-controller ``shard_map``s
over a ``Mesh`` of devices.  The port keeps that model in explicit SPMD
form: a :class:`~.mesh.Mesh` is a (channels, blocks) grid of torch devices,
a :class:`~.mesh.Sharded` holds one tensor per grid cell, and a sharded step
is written as stages: a map over the shards, a collective over the lists of
one mesh axis's shards (``collectives.py``), another map.  A grid may repeat
a device, so every shard, halo and reduction runs for real on one card (or
on the CPU in the tests); on several cards the shards sit on their own
cards and move between them by peer copies.

- ``mesh.py``: ``Mesh``, ``make_mesh``, ``shard``/``unshard``;
- ``collectives.py``: ``axis_index``, ``axis_size``, ``ppermute``,
  ``psum``, ``pmean``;
- ``halo.py``: the boundary halos of the overlap-save stages;
- ``generate.py``: communication-free sharded window generation;
- ``dryrun.py``: the eight-stage multi-shard smoke run.
"""
