"""Collectives of the port (counterpart of ``repro.parallel``): the exact
integer all-reduces of ``collectives``. The pipeline schedule waits for
the sharded model (ROADMAP queue 1, *Multi-device*, the sharded model);
``parallel.compat`` has no analogue (it shims ``shard_map``), and its
``axis_size`` lives in ``parallel.axes`` with the other named-axis
collectives."""
