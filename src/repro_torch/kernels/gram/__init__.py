from repro_torch.kernels.gram.ops import batched_gram_matrix, gram_matrix
from repro_torch.kernels.gram.ref import gram_ref

__all__ = ["batched_gram_matrix", "gram_matrix", "gram_ref"]
