"""Gateway tier: the batched-verify front door in front of the pool (port
of plenum_tpu/gateway/). Public surface:

* :class:`~plenum_tpu_torch.gateway.gateway.Gateway` — the glue (pump()).
* :class:`~plenum_tpu_torch.gateway.intake.GatewayIntake` /
  :class:`~plenum_tpu_torch.gateway.intake.SenderRegistry` — wire guard,
  dedup, batched ed25519 pre-screen.
* :class:`~plenum_tpu_torch.gateway.admission.AdmissionController` —
  backpressure ladder (reads shed before writes).
* :class:`~plenum_tpu_torch.gateway.read_cache.SignedReadCache` —
  proof-verified read replay keyed on BLS-signed roots.
* :mod:`~plenum_tpu_torch.gateway.lane_router` — deterministic conflict-lane
  pre-planning for outbound write envelopes.
"""
from plenum_tpu_torch.gateway.admission import (          # noqa: F401
    ADMIT_ALL, SHED_READS, SHED_WRITES, AdmissionController)
from plenum_tpu_torch.gateway.gateway import (            # noqa: F401
    Gateway, GatewayTick, cache_key_for, is_read, pack_write_envelopes)
from plenum_tpu_torch.gateway.intake import (             # noqa: F401
    GatewayIntake, SenderRegistry)
from plenum_tpu_torch.gateway.lane_router import (        # noqa: F401
    plan_write_lanes, route_by_lane, touched_keys_for)
from plenum_tpu_torch.gateway.read_cache import SignedReadCache  # noqa: F401
