"""The configuration values the port's write path reads (a copy of the
JAX package's Config defaults for these names)."""


class Config:
    # ---- 3PC batching (reference plenum/config.py:253-276)
    Max3PCBatchSize = 1000

    # batch size at which CoalescingVerifierHub leaves the scalar CPU
    # floor for a device launch
    VERIFIER_BATCH_THRESHOLD = 32
