"""Measurement tools of the port that run on the card: the step-overhead
probe (step_probe.py, kernel 10)."""
