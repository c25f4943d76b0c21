"""SARIF 2.1.0 output — the interchange format CI review UIs ingest.

GitHub code scanning, GitLab SAST, VS Code's SARIF viewer and most
code-review bots all speak SARIF; emitting it directly means the
pre-commit/CI recipe (``plenum_lint --changed --sarif``, see README)
annotates diffs with findings without any adapter glue.

Mapping choices:

* one ``run`` with the full rule catalog under ``tool.driver.rules``
  (``helpUri`` points at docs/static_analysis.md);
* finding severity ``error``/``warning`` → SARIF ``level`` verbatim;
* baseline state is preserved: grandfathered findings emit
  ``baselineState: "unchanged"``, new ones ``"new"`` — a SARIF
  consumer can mirror the gate's new-findings-only policy;
* ``partialFingerprints`` carries the baseline key (rule, path,
  symbol, message) so result identity is line-drift-proof, same as
  ``lint_baseline.json``.
"""
from __future__ import annotations

from typing import List

from plenum_tpu_torch.analysis.core import Finding, Rule

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")
DOCS_URI = "docs/static_analysis.md"


def _rule_descriptor(rule: Rule) -> dict:
    return {
        "id": rule.code,
        "name": rule.name,
        "shortDescription": {"text": rule.name},
        "helpUri": DOCS_URI,
        "defaultConfiguration": {
            "level": "error" if rule.severity == "error" else "warning",
        },
    }


def to_sarif(findings: List[Finding], baselined: set,
             rules: List[Rule]) -> dict:
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "baselineState": ("unchanged" if f in baselined
                              else "new"),
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": max(f.col + 1, 1),
                    },
                },
                "logicalLocations": [{
                    "fullyQualifiedName": f.symbol or f.path,
                }],
            }],
            "partialFingerprints": {
                "plenumLintKey/v1": "%s|%s|%s|%s" % (
                    f.rule, f.path, f.symbol, f.message),
            },
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "plenum-lint",
                    "informationUri": DOCS_URI,
                    "rules": [_rule_descriptor(r) for r in rules],
                },
            },
            "originalUriBaseIds": {
                "SRCROOT": {"description": {
                    "text": "repository root"}},
            },
            "results": results,
        }],
    }
