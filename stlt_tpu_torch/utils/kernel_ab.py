"""Pair the phase-2 kernel medians of two trees run in turns in one call.

``chip_smoke.py`` logs every timed kernel case as a ``kernel_check {json}``
line (``ms`` the median of five windows of five launches, ``ms_spread`` the
windows' fastest and slowest). Run the phase-2 functions of a parent tree
and of this tree in turns on one card (parent, change, change, parent),
each into its own log, for example::

    (cd PARENT && python3 chip_smoke.py --only check_train_kernels,... > ../p1.log)
    python3 chip_smoke.py --only check_train_kernels,... > c1.log
    ...
    python -m stlt_tpu_torch.utils.kernel_ab --parent p1.log p2.log --change c1.log c2.log

It prints one ``kernel_ab {json}`` line per case present in every log: the
parent's and the change's medians (the mean of each tree's runs), the
change over the parent, the spread (the widest of each log's window
spread relative to its median and each tree's run-to-run difference
relative to its mean), and whether the change is slower than the parent by
more than 3 % beyond that spread; then a ``kernel_ab_summary`` line.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Tuple

# The fields that name a case; the rest are its measurements.
_CASE_KEYS = ("name", "stage", "shape", "dtype", "clips", "rows", "T", "S", "tokens", "rate",
              "causal", "bias", "offsets", "lengths", "route")
# The medians a row may hold (``kernel_check`` lines of the attention
# backwards also time their forward with dropout).
_TIMES = ("ms", "forward_dropout_ms")
SLOWER_BEYOND_SPREAD = 0.03


def cases(path: str) -> Dict[Tuple, Tuple[float, list]]:
    """{case key: (median ms, [fastest, slowest] window)} of one log's timed
    ``kernel_check`` rows (a case timed twice in one log keeps its first)."""
    out: Dict[Tuple, Tuple[float, list]] = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("kernel_check {"):  # the timed cases' JSON rows only
                continue
            row = json.JSONDecoder().raw_decode(line[len("kernel_check "):])[0]
            case = tuple((k, json.dumps(row[k])) for k in _CASE_KEYS if k in row)
            for metric in _TIMES:
                if metric in row:
                    spread = row.get(metric + "_spread", [row[metric]] * 2)
                    out.setdefault(case + (("metric", json.dumps(metric)),), (row[metric], spread))
    return out


def pair(parents: List[str], changes: List[str]) -> List[dict]:
    runs = {"parent": [cases(p) for p in parents], "change": [cases(c) for c in changes]}
    common = set.intersection(*(set(r) for tree in runs.values() for r in tree))
    rows = []
    for key in sorted(common):
        row = {k: json.loads(v) for k, v in key}
        spread = 0.0
        for tree, logs in runs.items():
            ms = [log[key][0] for log in logs]
            row[f"{tree}_ms"] = sum(ms) / len(ms)
            spread = max(spread, (max(ms) - min(ms)) / row[f"{tree}_ms"])
            for log in logs:
                (median, (lo, hi)) = log[key]
                spread = max(spread, (hi - lo) / median)
        row["change_over_parent"] = row["change_ms"] / row["parent_ms"]
        row["spread"] = spread
        row["slower"] = row["change_over_parent"] > 1.0 + SLOWER_BEYOND_SPREAD + spread
        rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", nargs="+", required=True)
    parser.add_argument("--change", nargs="+", required=True)
    args = parser.parse_args(argv)
    rows = pair(args.parent, args.change)
    for row in rows:
        print("kernel_ab " + json.dumps(row))
    slower = [r for r in rows if r["slower"]]
    print("kernel_ab_summary " + json.dumps({
        "cases": len(rows), "slower_beyond_spread": len(slower),
        "geomean_change_over_parent": (
            math.prod(r["change_over_parent"] for r in rows) ** (1 / len(rows)) if rows else None)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
