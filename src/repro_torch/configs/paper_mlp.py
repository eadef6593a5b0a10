"""The paper's own Fashion-MNIST MLP (§III): config handles for the
trainer."""
from repro_torch.models.mlp import PaperMLPConfig

CONFIG = PaperMLPConfig()
REDUCED = PaperMLPConfig(hidden=16)
