"""The distribution layer (counterpart of ``blackman_harris_win_tpu/dist/``).

The JAX package runs its sharded steps as single-controller ``shard_map``s
over a ``Mesh`` of devices.  The port keeps that model in explicit SPMD
form: a :class:`~.mesh.Mesh` is a (channels, blocks) grid of torch devices,
each cell held by one process, a :class:`~.mesh.Sharded` holds one tensor
per cell this process holds (a ``Remote`` placeholder for the others), and
a sharded step is written as stages: a map over the local shards
(``mesh.local_map``), a collective over the lists of one mesh axis's shards
(``collectives.py``), another map.  A grid may repeat a device, so every
shard, halo and reduction runs for real on one card (or on the CPU in the
tests); on several cards of one process the shards sit on their own cards
and move between them by peer copies; across processes they move by
``torch.distributed`` point-to-point calls.

- ``mesh.py``: ``Mesh``, ``make_mesh``, ``shard``/``unshard``,
  ``local_map`` and the transfers between processes;
- ``collectives.py``: ``axis_index``, ``axis_size``, ``ppermute``,
  ``psum``, ``pmean``;
- ``halo.py``: the boundary halos of the overlap-save stages;
- ``generate.py``: communication-free sharded window generation;
- ``multihost.py``: the process group's start-up and ``pod_mesh``;
- ``dryrun.py``: the eight-stage multi-shard smoke run.
"""
