"""Worker sizing of the JAX package's pipeline runtime
(plenum_tpu/runtime/pipeline.py:79). The pipeline itself (worker-thread
wire parse and ed25519 pre-screen, PIPELINE_ENABLED) is not ported yet
(ROADMAP A7); the verify daemon sizes its worker pool with this rule."""
import os
from typing import Optional

# auto sizing never spawns more stage workers than this
_AUTO_WORKER_CAP = 4


def resolve_workers(configured: Optional[int] = None,
                    fallback: Optional[int] = None) -> int:
    """The single worker-sizing rule (Config.PIPELINE_WORKERS): an
    explicit value wins; None = ``fallback`` when the caller has a
    structural reason for one (the verify daemon's serialize-by-one
    floor), else auto = cores−1, capped, floor 1."""
    if configured is not None:
        return max(1, int(configured))
    if fallback is not None:
        return max(1, int(fallback))
    cores = os.cpu_count() or 1
    return max(1, min(_AUTO_WORKER_CAP, cores - 1))
