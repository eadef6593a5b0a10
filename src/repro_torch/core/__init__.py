"""Protocol core of the port: similarity, engines, one-shot clustering."""
from repro_torch.core.clustering import spectral_clusters

__all__ = ["spectral_clusters"]
