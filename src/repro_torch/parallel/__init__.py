"""Collectives of the port (counterpart of ``repro.parallel``): the exact
integer all-reduces of ``collectives`` and the named-axis collectives of
``axes``. The pipeline schedule waits for ROADMAP queue 1, *Multi-device*,
placement and entry points;
``parallel.compat`` has no analogue (it shims ``shard_map``), and its
``axis_size`` lives in ``parallel.axes`` with the other named-axis
collectives."""
