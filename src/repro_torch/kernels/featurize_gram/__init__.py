from repro_torch.kernels.featurize_gram.ops import (COMPUTE_DTYPES,
                                                    batched_featurize_gram,
                                                    featurize_gram)
from repro_torch.kernels.featurize_gram.ref import featurize_gram_ref

__all__ = ["COMPUTE_DTYPES", "batched_featurize_gram", "featurize_gram",
           "featurize_gram_ref"]
