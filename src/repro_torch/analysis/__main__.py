"""CLI entry point: ``python -m repro_torch.analysis module:callable``.

The target is a zero-argument callable returning a
:class:`~repro_torch.core.program.SimProgram` with an example state
declared (``prog.example_state(state)``): the ``make_program``
convention every in-repo scenario follows.  Exit status is 0 when the report is clean
and, under ``--strict``, 1 when any error-severity finding remains
(warnings never fail the lint: open-system programs legitimately warn
until their entry points are declared).
"""

from __future__ import annotations

import argparse
import importlib
import sys

from repro_torch.analysis.passes import analyze


def _resolve(target: str):
    if ":" not in target:
        raise SystemExit(
            f"target {target!r} must be 'module:callable', e.g. "
            "repro_torch.examples.phold:make_program"
        )
    mod_name, attr = target.split(":", 1)
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr, None)
    if fn is None:
        raise SystemExit(f"{mod_name} has no attribute {attr!r}")
    prog = fn() if callable(fn) else fn
    return prog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Statically analyze a SimProgram (event-flow graph, "
        "lookahead soundness, reachability, emit-row sanitation, "
        "purity).",
    )
    ap.add_argument(
        "target",
        help="module:callable returning a SimProgram with an example "
        "state (e.g. repro_torch.examples.phold:make_program)",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any error-severity finding")
    ap.add_argument("--hot-words", type=int, metavar="W", default=None,
                    help="also print the first W statically reachable "
                    "compositions (the hot_words='static' set)")
    args = ap.parse_args(argv)

    report = analyze(_resolve(args.target))
    if args.json:
        print(report.to_json())
    else:
        print(report.to_text())
        if args.hot_words:
            print(f"  static hot words (top {args.hot_words}): "
                  f"{report.static_hot_words(args.hot_words)}")
    if args.strict and not report.ok:
        print(f"strict: {len(report.errors)} error-severity finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
