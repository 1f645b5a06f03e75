"""Model layers of the port: the transformer LM, sampling, the paged KV
serving path and the ServeEngine."""
