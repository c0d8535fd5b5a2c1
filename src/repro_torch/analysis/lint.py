"""Hazard linter CLI, the port of ``repro/analysis/lint.py``.

Usage::

    python -m repro_torch.analysis.lint <module:fn | path/to/file.py[:fn]>
    python -m repro_torch.analysis.lint --corpus [--golden tests/data/...json]

The first form imports the target (dotted module or a ``.py`` path;
``fn`` defaults to ``main``), runs it under the event capture and prints
the hazard report — exit 1 when hazards are found, 0 when clean, 2 on a
load/run error.  ``--device`` (default ``cuda``) is passed to the target
as ``device=`` when it takes one.  ``--graph`` requires the export-graph
walker pass, ``--no-graph`` skips it (JAX's ``--jaxpr``/``--no-jaxpr``).

``--corpus`` runs the ported seeded-hazard corpus
(:mod:`repro_torch.analysis.corpus`, all 34 of JAX's cases) on
``--device`` and checks every case against its pinned expectation;
``--golden FILE`` checks against JAX's golden file instead
(``tests/data/hazard_corpus.json``; a case of the file that the port
lacks is a mismatch), and ``--write-golden FILE`` writes the port's
codes to ``FILE`` (never to JAX's file).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import sys
from typing import Callable

from repro_torch.analysis.capture import analyze
from repro_torch.analysis.model import HazardReport

#: JAX's golden file, which the port reads and never writes.
JAX_GOLDEN = os.path.join("tests", "data", "hazard_corpus.json")


def _load_target(target: str) -> Callable:
    mod_name, _, fn_name = target.partition(":")
    fn_name = fn_name or "main"
    if mod_name.endswith(".py") or "/" in mod_name:
        spec = importlib.util.spec_from_file_location("_lint_target",
                                                      mod_name)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {mod_name!r}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod_name)
    fn = getattr(module, fn_name, None)
    if not callable(fn):
        raise ImportError(f"{target!r} is not a callable "
                          f"({mod_name}:{fn_name})")
    return fn


def _run_corpus(golden: str, write_golden: str, as_json: bool,
                device: str) -> int:
    from repro_torch.analysis import corpus
    actual = {}
    for case in corpus.CASES:
        actual[case.name] = corpus.run_case(case, device=device).codes
    if write_golden:
        if os.path.abspath(write_golden).endswith(os.sep + JAX_GOLDEN):
            print(f"error: {write_golden} is JAX's golden file; the port "
                  "writes its codes elsewhere", file=sys.stderr)
            return 2
        with open(write_golden, "w") as f:
            json.dump({"cases": actual}, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {write_golden} ({len(actual)} cases)")
        return 0
    if golden:
        with open(golden) as f:
            expected = json.load(f)["cases"]
    else:
        expected = {c.name: sorted(c.expect) for c in corpus.CASES}
    failures = []
    for name, codes in sorted(actual.items()):
        want = sorted(expected.get(name, []))
        if codes != want:
            failures.append((name, want, codes))
    # a golden case the port lacks is a mismatch: none may be skipped
    waiting = sorted(n for n in expected if n not in actual)
    failures += [(n, sorted(expected[n]), None) for n in waiting]
    if as_json:
        print(json.dumps({"cases": actual,
                          "failures": [list(f) for f in failures],
                          "not_ported": waiting},
                         indent=2, sort_keys=True))
    else:
        for name, want, got in failures:
            print(f"MISMATCH {name}: expected {want}, found "
                  f"{'no such case' if got is None else got}")
        print(f"corpus: {len(actual) - len(failures)}/{len(actual)} "
              f"ported cases match (device {device})")
    return 1 if failures else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="GPU-First hazard linter (PyTorch/CUDA port)")
    parser.add_argument("target", nargs="?",
                        help="module:fn or path/to/file.py[:fn] "
                             "(fn defaults to main)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the report as JSON")
    parser.add_argument("--graph", action="store_true",
                        help="require the export-graph walker pass")
    parser.add_argument("--no-graph", action="store_true",
                        help="skip the export-graph walker pass")
    parser.add_argument("--device", default="cuda",
                        help="device of the corpus, and of a target that "
                             "takes device= (default: cuda)")
    parser.add_argument("--corpus", action="store_true",
                        help="lint the builtin seeded-hazard corpus")
    parser.add_argument("--golden", default="",
                        help="with --corpus: JSON golden file to check")
    parser.add_argument("--write-golden", default="",
                        help="with --corpus: write the port's codes here")
    args = parser.parse_args(argv)

    if args.corpus:
        try:
            return _run_corpus(args.golden, args.write_golden, args.as_json,
                               args.device)
        except Exception as exc:
            print(f"error: the corpus failed on {args.device}: {exc!r}",
                  file=sys.stderr)
            return 2
    if not args.target:
        parser.print_usage(sys.stderr)
        return 2

    try:
        fn = _load_target(args.target)
    except Exception as exc:
        print(f"error: cannot load {args.target!r}: {exc}",
              file=sys.stderr)
        return 2
    graph = True if args.graph else (False if args.no_graph else None)
    kw = {}
    try:
        if "device" in inspect.signature(fn).parameters:
            kw["device"] = args.device
    except (TypeError, ValueError):
        pass
    try:
        report = analyze(fn, graph=graph, **kw)
    except Exception as exc:
        print(f"error: {args.target!r} failed under analysis: {exc!r}",
              file=sys.stderr)
        return 2
    _print_report(args.target, report, args.as_json)
    return 1 if report else 0


def _print_report(target: str, report: HazardReport,
                  as_json: bool) -> None:
    if as_json:
        print(report.to_json())
    else:
        print(f"{target}: {report.summary()}")


if __name__ == "__main__":
    sys.exit(main())
