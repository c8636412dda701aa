from repro_torch.kernels.rwkv6_scan.ops import (
    launches,
    reset_launches,
    rwkv6_scan,
)
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
