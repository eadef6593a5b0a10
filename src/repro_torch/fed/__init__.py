"""Federated-learning layer of the port (``src/repro/fed``), so far only
the cluster-stack layout helpers of ``partition.py``."""
