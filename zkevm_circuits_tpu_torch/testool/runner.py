"""testool CLI (port of zkevm_circuits_tpu/testool/runner.py; reference
`testool/src/main.rs:349`).  Its levels are host work: no device.

    python -m zkevm_circuits_tpu_torch.testool.runner --oneliner "call 12;6001600201"
    python -m zkevm_circuits_tpu_torch.testool.runner --path tests_dir --level mock
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from .json_parser import load_json_fillers, load_yaml_fillers
from .oneliner import parse_oneliner
from .statetest import CircuitsConfig, StateTestResult, run_state_test


def collect(path: pathlib.Path):
    tests = []
    files = (
        [path] if path.is_file()
        else sorted(path.rglob("*.json"))
        + sorted(path.rglob("*.yml")) + sorted(path.rglob("*.yaml"))
    )
    for f in files:
        loader = load_yaml_fillers if f.suffix in (".yml", ".yaml") \
            else load_json_fillers
        try:
            tests.extend(loader(f.read_text()))
        except Exception as e:  # malformed filler: surface as failure
            tests.append((f.name, e))
    return tests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="testool")
    ap.add_argument("--oneliner", help="run a one-liner spec")
    ap.add_argument("--path", help="state-test JSON file or directory")
    ap.add_argument(
        "--level", default="trace", choices=["trace", "witness", "mock"]
    )
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--filter", default="", help="substring name filter")
    args = ap.parse_args(argv)

    config = CircuitsConfig(level=args.level, k=args.k)
    results: list[StateTestResult] = []
    if args.oneliner:
        results.append(run_state_test(parse_oneliner(args.oneliner), config))
    if args.path:
        for t in collect(pathlib.Path(args.path)):
            if isinstance(t, tuple):  # (filename, parse error)
                results.append(StateTestResult(
                    t[0], ok=False, reason=f"parse: {t[1]}"
                ))
                continue
            if args.filter and args.filter not in t.name:
                continue
            results.append(run_state_test(t, config))

    npass = sum(r.ok and not r.skipped for r in results)
    nskip = sum(r.skipped for r in results)
    nfail = sum(not r.ok for r in results)
    for r in results:
        line = f"[{r.status:>4}] {r.name}"
        if r.reason:
            line += f"  ({r.reason})"
        print(line)
    print(f"== {npass} passed, {nskip} skipped, {nfail} failed ==")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
