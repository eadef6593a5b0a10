from repro_torch.kernels.linkage.ops import (chain_plan, linkage_step,
                                             nn_chain, nn_chain_grouped)
from repro_torch.kernels.linkage.ref import (LINKAGES, linkage_step_ref,
                                             nn_chain_cached_ref,
                                             nn_chain_grouped_ref,
                                             nn_chain_ref)

__all__ = ["LINKAGES", "chain_plan", "linkage_step", "linkage_step_ref",
           "nn_chain", "nn_chain_cached_ref", "nn_chain_grouped",
           "nn_chain_grouped_ref", "nn_chain_ref"]
