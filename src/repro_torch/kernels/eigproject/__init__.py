from repro_torch.kernels.eigproject.ops import project_norms, project_norms_all
from repro_torch.kernels.eigproject.ref import (project_norms_all_ref,
                                                project_norms_ref)

__all__ = ["project_norms", "project_norms_all", "project_norms_ref",
           "project_norms_all_ref"]
