"""The paper's own CIFAR-10 CNN (§III): config handles for the trainer."""
from repro_torch.models.cnn import PaperCNNConfig

CONFIG = PaperCNNConfig()
REDUCED = PaperCNNConfig(c1=4, c2=8, fc1=32, fc2=16)
