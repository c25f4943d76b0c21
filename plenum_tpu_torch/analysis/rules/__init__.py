"""Rule registry — one module per rule, one instance per analysis run.

Adding a rule: create ``ptNNN_<slug>.py`` with a ``Rule`` subclass,
import it here, append the class to ``RULE_CLASSES``, document it in
``docs/static_analysis.md`` and give it fixtures in
``tests/test_plenum_lint.py``. Codes are PTnnn; PT000 is reserved for
parse errors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from plenum_tpu_torch.analysis.core import Rule, SEVERITIES
from plenum_tpu_torch.analysis.rules.pt001_blocking import BlockingCallRule
from plenum_tpu_torch.analysis.rules.pt002_host_sync import (
    HostSyncInDispatchRule)
from plenum_tpu_torch.analysis.rules.pt003_quorum_auth import (
    QuorumBeforeAuthRule)
from plenum_tpu_torch.analysis.rules.pt004_threads import (
    CrossThreadSharedStateRule)
from plenum_tpu_torch.analysis.rules.pt005_config_drift import (
    ConfigLiteralDriftRule)
from plenum_tpu_torch.analysis.rules.pt006_broad_except import (
    BroadExceptOnDevicePathRule)
from plenum_tpu_torch.analysis.rules.pt007_fixed_retry_timer import (
    FixedRetryTimerRule)
from plenum_tpu_torch.analysis.rules.pt008_per_item_hot_loop import (
    PerItemHotLoopRule)
from plenum_tpu_torch.analysis.rules.pt009_metric_cardinality import (
    UnboundedMetricCardinalityRule)
from plenum_tpu_torch.analysis.rules.pt010_wire_serializer import (
    WireSerializerLoopRule)
from plenum_tpu_torch.analysis.rules.pt011_declared_keys import (
    DeclaredKeysRule)
from plenum_tpu_torch.analysis.rules.pt012_nondeterminism import (
    NondeterminismRule)
from plenum_tpu_torch.analysis.rules.pt013_dispatch_collect import (
    DispatchWithoutCollectRule)
from plenum_tpu_torch.analysis.rules.pt014_compile_cardinality import (
    CompileCardinalityRule)
from plenum_tpu_torch.analysis.rules.pt015_trace_taint import (
    TraceContextTaintRule)
from plenum_tpu_torch.analysis.rules.pt016_region_state import (
    CrossRegionMutableStateRule)
from plenum_tpu_torch.analysis.rules.pt017_handoff import (
    HandoffDisciplineRule)

RULE_CLASSES = (
    BlockingCallRule,
    HostSyncInDispatchRule,
    QuorumBeforeAuthRule,
    CrossThreadSharedStateRule,
    ConfigLiteralDriftRule,
    BroadExceptOnDevicePathRule,
    FixedRetryTimerRule,
    PerItemHotLoopRule,
    UnboundedMetricCardinalityRule,
    WireSerializerLoopRule,
    DeclaredKeysRule,
    NondeterminismRule,
    DispatchWithoutCollectRule,
    CompileCardinalityRule,
    TraceContextTaintRule,
    CrossRegionMutableStateRule,
    HandoffDisciplineRule,
)


def build_rules(disable: Sequence[str] = (),
                select: Sequence[str] = (),
                severities: Optional[Dict[str, str]] = None,
                root: str = None) -> List[Rule]:
    """Instantiate the registry with per-rule enable/severity applied.
    `select` (when non-empty) wins over `disable`; unknown codes raise
    so a typo'd suppression cannot silently disable nothing."""
    known = {cls.code for cls in RULE_CLASSES}
    for code in list(disable) + list(select) + sorted(severities or {}):
        if code.upper() not in known:
            raise ValueError("unknown rule code %r (known: %s)"
                             % (code, ", ".join(sorted(known))))
    disabled = {c.upper() for c in disable}
    selected = {c.upper() for c in select}
    rules: List[Rule] = []
    for cls in RULE_CLASSES:
        if selected and cls.code not in selected:
            continue
        if cls.code in disabled:
            continue
        rule = cls(root=root) if cls is ConfigLiteralDriftRule else cls()
        sev = (severities or {}).get(cls.code)
        if sev is not None:
            if sev not in SEVERITIES:
                raise ValueError("unknown severity %r for %s (one of %s)"
                                 % (sev, cls.code, "/".join(SEVERITIES)))
            rule.severity = sev
        rules.append(rule)
    return rules
