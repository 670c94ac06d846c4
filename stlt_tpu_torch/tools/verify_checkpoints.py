#!/usr/bin/env python
"""Released-checkpoint accuracy check through the port's ``inference``.

Own copy of ``tools/verify_checkpoints.py``: a manifest
(``tools/zoo_manifest.example.json``'s schema) binds each checkpoint to its
dataset files, flags and expected metrics (the reference's
``src/inference.py`` printout, metrics x 100), and each entry runs through
``stlt_tpu_torch.inference``:

    python -m stlt_tpu_torch.tools.verify_checkpoints --manifest zoo/manifest.json

Per entry one JSON line, ``{"name", "metrics", "expected", "delta",
"tolerance", "pass"}`` (``pass`` null where nothing is expected, and
``{"name", "skipped_missing_files"}`` where a file is absent); exit status
1 if an asserted entry misses its tolerance. Relative paths resolve against
the manifest's directory. Entries run on the card; ``"extra_args":
{"platform": "cpu"}`` runs one on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

DEFAULT_TOLERANCE = 0.2  # percentage points, the BASELINE.md +-0.2% bar

# argv fragments per entry key; only keys present in the entry are emitted.
_PATH_FLAGS = ("checkpoint_path", "test_dataset_path", "labels_path", "videoid2size_path",
               "videos_path", "resnet_model_path")
_CONFIG_FLAGS = ("dataset_name", "dataset_type", "model_name")


def entry_argv(entry: dict) -> list:
    """The ``inference`` argv of one entry. ``batch_size`` comes from
    ``extra_args`` only: a top-level key would add a second flag that
    argparse silently takes the last of."""
    argv = []
    for key in _CONFIG_FLAGS:
        argv += [f"--{key}", str(entry[key])]
    for key in _PATH_FLAGS:
        if entry.get(key):
            argv += [f"--{key}", str(entry[key])]
    for key, value in entry.get("extra_args", {}).items():
        argv += [f"--{key}", str(value)]
    return argv


def missing_files(entry: dict) -> list:
    return [entry[key] for key in _PATH_FLAGS if entry.get(key) and not os.path.exists(entry[key])]


def score(metrics: dict, entry: dict) -> dict:
    """The entry's record from its metrics: scaled x 100 to 2 decimals as
    the reference prints them (inference.py:80-85), each expected one's
    delta, and whether all are within the tolerance."""
    scaled = {k: round(v * 100, 2) for k, v in metrics.items()}
    expected = entry.get("expected") or {}
    tolerance = float(entry.get("tolerance", DEFAULT_TOLERANCE))
    ok = None
    deltas = {}
    if expected:
        ok = True
        for key, want in expected.items():
            got = scaled.get(key)
            if got is None:
                ok = False
                deltas[key] = "metric missing"
                continue
            deltas[key] = round(got - float(want), 3)
            if abs(got - float(want)) > tolerance:
                ok = False
    return {"name": entry.get("name", entry.get("checkpoint_path")), "metrics": scaled,
            "expected": expected, "delta": deltas, "tolerance": tolerance, "pass": ok}


def run_entry(entry: dict) -> dict:
    """Run ``inference`` for one manifest entry; returns its record."""
    from stlt_tpu_torch.inference import inference
    from stlt_tpu_torch.parser import build_parser

    args = build_parser("checkpoint verification").parse_args(entry_argv(entry))
    return score(inference(args), entry)


def verify_manifest(manifest_path: str, only: str = "") -> list:
    with open(manifest_path) as f:
        manifest = json.load(f)
    base = os.path.dirname(os.path.abspath(manifest_path))
    results = []
    for entry in manifest["entries"]:
        if only and only not in entry.get("name", ""):
            continue
        entry = dict(entry)
        for key in _PATH_FLAGS:
            if entry.get(key) and not os.path.isabs(entry[key]):
                entry[key] = os.path.join(base, entry[key])
        absent = missing_files(entry)
        if absent:
            results.append({"name": entry.get("name"), "skipped_missing_files": absent})
            continue
        results.append(run_entry(entry))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--manifest", default=os.environ.get("STLT_ZOO_MANIFEST", ""),
                        help="zoo manifest JSON (or set STLT_ZOO_MANIFEST)")
    parser.add_argument("--only", default="", help="substring filter on entry names")
    args = parser.parse_args(argv)
    if not args.manifest:
        parser.error("--manifest (or STLT_ZOO_MANIFEST) is required")
    failed = False
    for record in verify_manifest(args.manifest, args.only):
        print(json.dumps(record), flush=True)
        failed |= record.get("pass") is False
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
