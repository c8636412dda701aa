from repro_torch.kernels.fedgia_update.ops import (
    LANES,
    fedgia_update,
    fedgia_update_batched,
    fedgia_update_batched_donated,
    fedgia_update_flat,
    fedgia_update_single,
    launches,
)
from repro_torch.kernels.fedgia_update.ref import (
    fedgia_update_collapsed,
    fedgia_update_ref,
)
