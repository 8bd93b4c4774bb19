"""CLI for the static verifier, range certification, and lint.

Port of ``repro/analysis/__main__.py``: the same commands, options,
output and exit codes.  ``verify``, ``ranges`` and ``all`` load the
saved payloads to the CPU (the passes read arrays and run no kernel), so
the CLI needs no GPU.

``python -m repro_torch.analysis verify <dir>`` exits 0 when the saved program
has no error diagnostics (warnings print but do not fail); ``--json``
emits the machine-readable report instead of text.

``python -m repro_torch.analysis ranges <dir>`` runs the range certification
pass (``repro_torch.analysis.ranges``) over a saved program:  structural
verification first, then the abstract interpreter; exits 0 when no
error diagnostics exist.  ``--json`` emits ``{"report": ...,
"certificate": ...}``; ``--input-lo``/``--input-hi`` override the
declared input range (default: the stored certificate's own range, or
``DEFAULT_INPUT_RANGE``).

``python -m repro_torch.analysis lint [paths...]`` (default ``src/repro_torch``)
exits 0 only when the tree is completely clean — CI treats lint
warnings as failures too, since every rule here guards a correctness
contract.

``python -m repro_torch.analysis all <dir> [--paths ...]`` runs verify + lint
+ ranges and emits one merged JSON report (always JSON; ``--json`` is
accepted for symmetry).

Exit codes:

=========  ============================================================
command    exit code
=========  ============================================================
verify     0 clean-of-errors; 1 error diagnostics
ranges     0 clean-of-errors; 1 error diagnostics
lint       0 completely clean; 1 any finding
all        bitmask of failure classes — 0 clean, ``+1`` verify errors,
           ``+2`` lint findings, ``+4`` ranges errors (so e.g. 5 means
           verify and ranges failed but lint was clean)
=========  ============================================================
"""

from __future__ import annotations

import argparse
import json
import sys

EXIT_VERIFY = 1
EXIT_LINT = 2
EXIT_RANGES = 4


def _emit(report, as_json: bool) -> None:
    print(report.dumps() if as_json else report.format())


def _ranges_json(report, cert) -> dict:
    return {
        "report": report.to_json(),
        "certificate": None if cert is None else cert.to_manifest(),
    }


def _parse_range(args):
    if (args.input_lo is None) != (args.input_hi is None):
        raise SystemExit("--input-lo and --input-hi must be given together")
    if args.input_lo is None:
        return None
    return (float(args.input_lo), float(args.input_hi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("verify", help="verify a saved program directory")
    v.add_argument("directory")
    v.add_argument("--json", action="store_true")

    rg = sub.add_parser(
        "ranges", help="range-certify a saved program directory"
    )
    rg.add_argument("directory")
    rg.add_argument("--json", action="store_true")
    rg.add_argument("--input-lo", type=float, default=None)
    rg.add_argument("--input-hi", type=float, default=None)

    li = sub.add_parser("lint", help="trace-safety lint over source trees")
    li.add_argument("paths", nargs="*", default=["src/repro_torch"])
    li.add_argument("--json", action="store_true")

    al = sub.add_parser(
        "all", help="verify + lint + ranges with one merged JSON report"
    )
    al.add_argument("directory")
    al.add_argument("--paths", nargs="*", default=["src/repro_torch"])
    al.add_argument("--json", action="store_true")
    al.add_argument("--input-lo", type=float, default=None)
    al.add_argument("--input-hi", type=float, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "verify":
        from repro_torch.analysis.verify import verify_saved

        report = verify_saved(args.directory)
        _emit(report, args.json)
        return 0 if report.ok else EXIT_VERIFY

    if args.cmd == "ranges":
        from repro_torch.analysis.ranges import analyze_saved

        report, cert = analyze_saved(
            args.directory, input_range=_parse_range(args)
        )
        if args.json:
            print(json.dumps(_ranges_json(report, cert), indent=2))
        else:
            print(report.format())
            if cert is not None:
                for entry in cert.layers:
                    cells = (
                        "" if entry.certified_cells is None
                        else f"  cells={entry.certified_cells}"
                        f"/{entry.stored_cells}"
                    )
                    print(
                        f"{entry.name}: act in "
                        f"[{entry.act_lo:.6g}, {entry.act_hi:.6g}]{cells}"
                    )
                print(f"fp32_safe={cert.fp32_safe}")
        return 0 if report.ok else 1

    if args.cmd == "lint":
        from repro_torch.analysis.lint import lint_paths

        report = lint_paths(args.paths or ["src/repro_torch"])
        _emit(report, args.json)
        return 0 if report.clean else 1

    # all: the three passes, one merged JSON document, a bitmask exit
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.ranges import analyze_saved
    from repro_torch.analysis.verify import verify_saved

    verify_report = verify_saved(args.directory)
    lint_report = lint_paths(args.paths or ["src/repro_torch"])
    ranges_report, cert = analyze_saved(
        args.directory, input_range=_parse_range(args)
    )
    code = 0
    if not verify_report.ok:
        code |= EXIT_VERIFY
    if not lint_report.clean:
        code |= EXIT_LINT
    if not ranges_report.ok:
        code |= EXIT_RANGES
    print(json.dumps({
        "ok": code == 0,
        "exit_code": code,
        "verify": verify_report.to_json(),
        "lint": lint_report.to_json(),
        "ranges": _ranges_json(ranges_report, cert),
    }, indent=2))
    return code


if __name__ == "__main__":
    sys.exit(main())
