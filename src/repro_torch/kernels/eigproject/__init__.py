from repro_torch.kernels.eigproject.ops import (eig_plan, project_norms,
                                               project_norms_all,
                                               project_norms_grouped)
from repro_torch.kernels.eigproject.ref import (project_norms_all_ref,
                                                project_norms_all_tf32,
                                                project_norms_grouped_ref,
                                                project_norms_ref,
                                                split_w_ref)

__all__ = ["eig_plan", "project_norms", "project_norms_all",
           "project_norms_grouped", "project_norms_ref",
           "project_norms_all_ref", "project_norms_all_tf32",
           "project_norms_grouped_ref", "split_w_ref"]
