"""The LM model zoo (decoder-only), PyTorch port of ``src/repro/models``."""
