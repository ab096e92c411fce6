"""Measurement scripts of the port, run on a CUDA card; no solver path
imports them."""
