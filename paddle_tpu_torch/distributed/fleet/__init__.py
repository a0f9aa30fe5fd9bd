"""fleet for the port: `meta_parallel.ring_attention`, the sequence-parallel
(sep axis) attention, and `recompute` (activation recompute; the module,
not re-exported here, so that `fleet.recompute` names it)."""
