"""The port's example entry points, counterparts of the repo's
``examples/*.py`` (``quickstart``, ``mthfl_train``, ``lm_federated``,
``serve_demo``), each run as ``python -m repro_torch.examples.<name>``.
``common`` holds the MT-HFL comparison the training example runs.

Each runs on the CUDA device unless given ``--device cpu``; each
``main(argv)`` returns what it printed, for the tests and
``chip_smoke.py``.
"""
