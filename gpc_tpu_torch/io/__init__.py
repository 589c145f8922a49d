"""Data and model file I/O of the port."""
