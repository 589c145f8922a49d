"""Kernel wrappers and evidence engines of the port."""
