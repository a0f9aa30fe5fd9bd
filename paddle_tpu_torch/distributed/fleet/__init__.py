"""fleet for the port: `meta_parallel.ring_attention`, the sequence-parallel
(sep axis) attention."""
