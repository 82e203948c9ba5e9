"""``python -m chainermn_torch.analysis`` — run graftlint from the shell.

Exit codes: 0 = no gating findings, 1 = errors (or parse failures),
2 = usage error. ``--baseline`` accepts previously recorded
fingerprints; ``--write-baseline`` records the current findings so a
new checker can ratchet instead of big-banging (the merged tree keeps
the baseline empty).
"""

from __future__ import annotations

import argparse
import json
import sys

from chainermn_torch.analysis.checkers import all_checkers
from chainermn_torch.analysis.core import (
    load_baseline,
    load_project,
    run_analysis,
    write_baseline,
)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m chainermn_torch.analysis",
        description="graftlint: AST-based repo-invariant analysis")
    p.add_argument("paths", nargs="+",
                   help="files or directories to analyze")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings on stdout")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="JSON fingerprint file of accepted findings")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="record current findings as the new baseline")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print available rule ids and exit")
    p.add_argument("--runtime-report", default=None, metavar="FILE",
                   help="sanitizer artifact (JSON) to merge with the "
                        "static lock-order graph; exits 1 on observed "
                        "edges absent from the static graph")
    return p


def _runtime_report(artifact_path: str, paths: list) -> int:
    """Merge the sanitizer's observed lock-order graph into the static
    one and assert observed ⊆ static (leaf-lock edges are terminal
    telemetry edges, reported but never gating)."""
    from chainermn_torch.analysis.checkers.locks import static_lock_graph
    from chainermn_torch.analysis.sanitizer import (
        artifact_class_edges,
        load_artifact,
    )

    artifact = load_artifact(artifact_path)
    observed = artifact_class_edges(artifact)
    project, parse_errors = load_project(paths)
    if parse_errors:
        for f in parse_errors:
            print(f.render())
        return 1
    static = static_lock_graph(project)

    both = sorted(observed & static)
    static_only = sorted(static - observed)
    observed_only = sorted(observed - static)
    leaf = sorted(tuple(e) for e in artifact.get("leaf_edges", ()))

    print("runtime lock-order report "
          f"({len(observed)} observed / {len(static)} static class edges)")
    for a, b in both:
        print(f"  both      {a} -> {b}")
    for a, b in static_only:
        print(f"  static    {a} -> {b}  (not exercised at runtime)")
    for a, b in leaf:
        print(f"  leaf      {a} -> {b}  (terminal telemetry lock)")
    for a, b in observed_only:
        print(f"  OBSERVED-ONLY  {a} -> {b}  — runtime took a lock "
              f"ordering the static graph does not know about")
    if observed_only:
        print("runtime-report: FAIL (observed graph is not a subgraph "
              "of the static graph)")
        return 1
    print("runtime-report: OK (observed ⊆ static)")
    return 0


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    checkers = all_checkers()
    if args.list_rules:
        for c in checkers:
            print(f"{c.rule}  (suppress: # graftlint: {c.suppress_token})")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {c.rule for c in checkers}
        if unknown:
            parser.error(f"unknown rule(s): {', '.join(sorted(unknown))}")
        checkers = [c for c in checkers if c.rule in wanted]

    if args.runtime_report:
        return _runtime_report(args.runtime_report, args.paths)

    baseline = load_baseline(args.baseline)
    result = run_analysis(args.paths, checkers, baseline=baseline)

    if args.write_baseline:
        write_baseline(args.write_baseline, result)

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        counts = result.to_json()["counts"]
        print(f"graftlint: {counts['errors']} error(s), "
              f"{counts['warnings']} warning(s), "
              f"{counts['suppressed']} suppressed, "
              f"{counts['baselined']} baselined")
    return 1 if result.errors else 0


if __name__ == "__main__":
    sys.exit(main())
