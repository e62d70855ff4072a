"""repro_torch.net — the interconnect as a level of the roofline (port of
``repro.net``).

1. **characterize** (``repro_torch.net.characterize``): collective
   microbenchmarks on the ranks of a real process group (gloo on the
   host, NCCL across cards) → measured ICI / DCN bandwidth and latency
   ceilings, stored under the machine key in the tune store;
2. **attribute** (``repro_torch.core.op_analysis`` +
   ``repro_torch.core.roofline``): the collectives a per-device walk
   counts land on those ceilings as each phase's ``net`` bounds;
3. **campaign** (``repro_torch.net.report`` + the sweep's
   ``mesh_shapes`` axis): where each config flips from memory-bound to
   network-bound.

``python -m repro_torch net {characterize,report}`` is the CLI.
"""

from repro_torch.net.characterize import (characterize_net,
                                          machine_with_net, net_ceilings)
from repro_torch.net.collectives import (LEGS, OPS, fit_ceiling,
                                         measure_collectives, payload_bytes,
                                         wire_bytes)

__all__ = [
    "LEGS", "OPS", "characterize_net", "fit_ceiling", "machine_with_net",
    "measure_collectives", "net_ceilings", "payload_bytes", "wire_bytes",
]
