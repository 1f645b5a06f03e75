"""Data subsystem of the port: the native (C++) token loader and the
dataset file utilities."""

from .loader import DataLoader, read_token_file, write_token_file

__all__ = ["DataLoader", "write_token_file", "read_token_file"]
