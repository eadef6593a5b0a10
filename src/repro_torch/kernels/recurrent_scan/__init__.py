from repro_torch.kernels.recurrent_scan.ops import (COMPUTE_DTYPES,
                                                    WKV_HEAD_DIMS,
                                                    linear_scan,
                                                    linear_scan_plan,
                                                    wkv_chunked)
from repro_torch.kernels.recurrent_scan.ref import (linear_scan_ref,
                                                    wkv_chunked_ref, wkv_ref)

__all__ = ["COMPUTE_DTYPES", "WKV_HEAD_DIMS", "linear_scan",
           "linear_scan_plan", "wkv_chunked",
           "linear_scan_ref", "wkv_chunked_ref", "wkv_ref"]
