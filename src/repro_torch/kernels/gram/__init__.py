from repro_torch.kernels.gram.ops import (batched_gram_matrix, gram_matrix,
                                          gram_plan)
from repro_torch.kernels.gram.ref import gram_3xtf32, gram_ref

__all__ = ["batched_gram_matrix", "gram_matrix", "gram_plan", "gram_3xtf32",
           "gram_ref"]
