"""Sequence parallelism of the port: so far the layout index math the
single-device trainer uses (the ring comes with a later slice)."""
