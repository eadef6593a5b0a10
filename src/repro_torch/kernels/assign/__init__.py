from repro_torch.kernels.assign.ops import COMPUTE_DTYPES, assign, assign_looped
from repro_torch.kernels.assign.ref import (assign_looped_plain, assign_ref,
                                            assign_wave_plain)

__all__ = ["COMPUTE_DTYPES", "assign", "assign_looped", "assign_ref",
           "assign_wave_plain", "assign_looped_plain"]
