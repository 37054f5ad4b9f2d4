"""Per-worker timeline of a pytest-xdist run: which worker ran each test
file, from when to when, each worker's busy seconds, and the port's files'
summed worker-seconds.

Stamp the run's output (``-vv`` names each test's worker; the Tier-1 line's
``-q`` cancels a single ``-v``), then read it:

    <pytest command with -n 6 --dist loadfile -vv> 2>&1 \\
        | python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.suite_timeline stamp > run.log
    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.suite_timeline read run.log

Times are seconds from the first line of output. A file's start is the end
of the test its worker reported before it (for a worker's first file, the
first test result of the run, once collection is done); its end is its last
test's report.
"""
from __future__ import annotations

import argparse
import collections
import re
import sys
import time

_RESULT = re.compile(r"^(\d+\.\d+) \[(gw\d+)\] \[\s*\d+%\] (PASSED|FAILED|ERROR|SKIPPED|XFAIL|XPASS) (\S+)")
# the port's own test files (test_torch_import.py is a JAX-package test)
_PORT = re.compile(r"tests/test_torch_(?!import\.py)\w+\.py$")


def stamp(stream=sys.stdin, out=sys.stdout) -> None:
    for line in stream:
        out.write(f"{time.time():.2f} {line}")
        out.flush()


def read(path: str) -> None:
    per_worker = collections.defaultdict(list)
    start = None
    with open(path) as f:
        for line in f:
            if start is None and line[:1].isdigit():
                start = float(line.split(" ", 1)[0])
            m = _RESULT.match(line)
            if m:
                per_worker[m.group(2)].append((float(m.group(1)), m.group(4).split("::")[0]))
    first = min(t for events in per_worker.values() for t, _ in events)
    end = max(t for events in per_worker.values() for t, _ in events)
    print(f"first result +{first - start:.0f} s, last result +{end - start:.0f} s")
    port = 0.0
    for worker, events in sorted(per_worker.items()):
        files, previous = {}, first
        for t, name in events:
            began, _, n = files.get(name, (previous, t, 0))
            files[name] = (began, t, n + 1)
            previous = t
        print(f"== {worker}: busy {sum(b - a for a, b, _ in files.values()):.0f} s")
        for name, (a, b, n) in sorted(files.items(), key=lambda kv: kv[1][0]):
            print(f"   +{a - start:6.0f} to +{b - start:6.0f} s ({b - a:5.0f} s, {n:3d} tests) {name}")
            port += (b - a) if _PORT.search(name) else 0.0
    print(f"the port's files: {port:.0f} worker-seconds")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stamp", help="prefix each line of stdin with the time")
    r = sub.add_parser("read", help="print the timeline of a stamped log")
    r.add_argument("log")
    args = ap.parse_args()
    stamp() if args.cmd == "stamp" else read(args.log)


if __name__ == "__main__":
    main()
