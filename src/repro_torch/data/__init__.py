"""Synthetic datasets (port of `repro/data`)."""
