from plenum_tpu_torch.runtime.timer import TimerService, QueueTimer, RepeatingTimer  # noqa: F401
from plenum_tpu_torch.runtime.bus import InternalBus, ExternalBus, Router  # noqa: F401
from plenum_tpu_torch.runtime.stashing_router import (  # noqa: F401
    StashingRouter, PROCESS, DISCARD, STASH,
)
