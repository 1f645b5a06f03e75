"""Training utilities of the port: checkpoints, step timing, logging."""
