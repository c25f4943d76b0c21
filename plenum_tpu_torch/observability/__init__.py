"""Observability plane — accumulators ride utils/metrics; this package
owns the other two instruments (docs/observability.md):

`tracing` owns the per-node ring-buffer Tracer (and the free NullTracer
the rest of the codebase holds by default); `export` turns any set of
tracers into one Chrome trace-event (Perfetto-loadable) timeline with a
"pid" row per node, a track per span category, and flow arrows pairing
stamped envelope sends with their receives; `telemetry` is the
always-on plane — latency histograms (p50/p99 on the ordered money
path), device-efficiency lane accounting at every bucket-padding
dispatch seam, pool-health gauges, Prometheus exposition; `budget`
turns recorded spans into per-stage host-ms budgets; `journey` joins
per-node buffers and wire-carried trace stamps into per-request
cross-node causal records and per-batch critical-path attribution.
"""
from plenum_tpu_torch.observability.tracing import (  # noqa: F401
    CAT_3PC, CAT_BLS, CAT_DEVICE, CAT_EXECUTE, CAT_INTAKE, CAT_PROPAGATE,
    CAT_REPLY, NullTracer, Tracer)
from plenum_tpu_torch.observability.telemetry import (  # noqa: F401
    TM, LogLinearHistogram, NullTelemetryHub, TelemetryHub,
    get_seam_hub, merged_snapshot, prometheus_text, set_seam_hub)
from plenum_tpu_torch.observability.journey import (  # noqa: F401
    causal_violations, journeys_from_chrome, journeys_from_tracers,
    pool_breakdown)
