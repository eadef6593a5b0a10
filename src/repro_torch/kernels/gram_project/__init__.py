from repro_torch.kernels.gram_project.ops import (batched_gram_project,
                                                  gram_project)
from repro_torch.kernels.gram_project.ref import gram_project_ref

__all__ = ["batched_gram_project", "gram_project", "gram_project_ref"]
