"""Model layers of the port: the transformer LM, sampling, speculative
decoding, the paged KV serving path and the ServeEngine."""

from .speculative import SpecStats, speculative_generate

__all__ = ["SpecStats", "speculative_generate"]
