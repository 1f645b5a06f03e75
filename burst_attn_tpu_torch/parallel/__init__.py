"""Sequence parallelism of the port: layouts, the ring schedule IR and
its arithmetic, the one-device mesh, and burst (ring) attention."""
