"""Interoperation with the JAX reference package."""
