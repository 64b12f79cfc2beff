"""Eval data: the standard HDF5 reader and synthetic pairs (numpy)."""
