"""Federated substrate of the port (``src/repro/fed``): the parameter
partition and cluster-stack layout, FedAvg, the LPS/GPS hierarchy, the
clients, the MT-HFL trainer (Algorithm 1) and the IFCA baseline."""
