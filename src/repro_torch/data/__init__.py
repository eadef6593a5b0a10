"""Data for the port: numpy generators copied from ``repro.data``."""
