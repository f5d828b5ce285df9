"""Committed-artifact integrity guards.

A failed measurement once got committed silently: ATE_EVAL.json carried
a NaN while README/BASELINE/PARITY quoted a stale good number from an
earlier commit. These tests make that state fail CI structurally:

1. every committed benchmark/eval artifact must contain only finite
   numbers (json.load parses bare ``NaN`` into float('nan'), so a failed
   drive that sneaks into an artifact is caught here), and
2. the headline figures the docs quote must match the artifact they cite
   to within quoting precision.

Reference anchor: the reference pins every behavior per package with
tests (SURVEY.md §4); these pin the repo's *reporting* the same way.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# Artifacts produced by this repo's own harnesses.
OWN_ARTIFACTS = [
    "ATE_EVAL.json",
    "BASELINE.json",
    "SCALING_MULTIHOST.json",
    "SCALING_r03.json",
    "baseline_measured.json",
]


def _nonfinite_paths(tree, prefix=""):
    bad = []
    if isinstance(tree, dict):
        for key, val in tree.items():
            bad += _nonfinite_paths(val, f"{prefix}{key}.")
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            bad += _nonfinite_paths(val, f"{prefix}{i}.")
    elif isinstance(tree, bool):
        pass
    elif isinstance(tree, (int, float)) and not math.isfinite(tree):
        bad.append(prefix.rstrip("."))
    return bad


@pytest.mark.parametrize("name", OWN_ARTIFACTS)
def test_artifact_is_finite(name):
    text = (ROOT / name).read_text()
    try:  # bare NaN/Infinity parse to non-finite floats
        tree = json.loads(text)
    except json.JSONDecodeError:  # JSONL artifacts (one object per line)
        tree = [json.loads(line) for line in text.splitlines() if line]
    bad = _nonfinite_paths(tree)
    assert not bad, (
        f"{name} contains non-finite metrics at {bad} — a failed run was "
        f"committed; re-run the producing harness (it must refuse to write "
        f"non-finite output) before updating docs")


def _artifact(name):
    with open(ROOT / name) as f:
        return json.load(f)


def _doc_figure(docname, pattern):
    """Extract the single float captured by ``pattern`` from a doc."""
    text = (ROOT / docname).read_text()
    match = re.search(pattern, text)
    assert match, f"{docname} no longer contains pattern {pattern!r}"
    return float(match.group(1))


# (doc, regex-with-one-capture, artifact, path-into-artifact, abs tol).
# Tolerance = one unit in the last place the doc quotes.
DOC_CLAIMS = [
    ("BASELINE.md", r"`slam_loop` \*\*([\d.]+) m ATE",
     "ATE_EVAL.json", ("slam_loop", "ate_rmse_m"), 0.0016),
    ("BASELINE.md", r"`slam_loop_imu`[^*]*\*\*([\d.]+) m ATE",
     "ATE_EVAL.json", ("slam_loop_imu", "ate_rmse_m"), 0.0016),
    ("README.md", r"\*\*([\d.]+) m ATE over an 80-scan",
     "ATE_EVAL.json", ("slam_loop", "ate_rmse_m"), 0.0016),
    ("README.md", r"\(([\d.]+) m\s*\nwith IMU",
     "ATE_EVAL.json", ("slam_loop_imu", "ate_rmse_m"), 0.0016),
    ("PARITY.md", r"`slam_loop` ([\d.]+) m /",
     "ATE_EVAL.json", ("slam_loop", "ate_rmse_m"), 0.0016),
    ("PARITY.md", r"`slam_loop_imu` ([\d.]+) m",
     "ATE_EVAL.json", ("slam_loop_imu", "ate_rmse_m"), 0.0016),
    ("README.md", r"ATE ([\d.]+) m on a full-shape synthetic drive",
     "ATE_EVAL.json", ("production_kitti_hdl64", "ate_rmse_m"), 0.0016),
    ("BASELINE.md", r"production `kitti_hdl64\(\)` \| \*\*([\d.]+) m\*\*",
     "ATE_EVAL.json", ("production_kitti_hdl64", "ate_rmse_m"), 0.0016),
    ("BASELINE.md", r"faithful \(point maps[^|]*\| ([\d.]+) m",
     "ATE_EVAL.json", ("faithful", "ate_rmse_m"), 0.0016),
]


@pytest.mark.parametrize(
    "doc,pattern,artifact,path,tol", DOC_CLAIMS,
    ids=[f"{d}:{p[:24]}" for d, p, a, _, _ in DOC_CLAIMS])
def test_doc_quote_matches_artifact(doc, pattern, artifact, path, tol):
    actual = _artifact(artifact)
    for key in path:
        actual = actual[key]
    quoted = _doc_figure(doc, pattern)
    assert math.isfinite(actual), (
        f"{artifact}:{'.'.join(path)} is non-finite but {doc} quotes "
        f"{quoted} — the doc cites a measurement that does not exist")
    assert abs(quoted - actual) <= tol, (
        f"{doc} quotes {quoted} for {artifact}:{'.'.join(path)} but the "
        f"committed artifact says {actual} (tol {tol}) — re-measure or "
        f"fix the doc; they must come from the same code state")
