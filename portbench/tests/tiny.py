"""Runs of the benchmark's cells on the CPU at a tiny size, for the tests:
the harness, the drivers and the reference as a run drives them, with the
port's CPU paths (the eager engine and train step) in place of the card's."""

from __future__ import annotations

import contextlib
import io
import json
import time

from portbench.harness import ROOT, run

# The published widths; frames, clips and batches cut to what a test holds.
OVERRIDES = {
    "archive": {"traffic": {"lengths": [40, 48], "videos_per_length": 2, "height": 32,
                            "width": 32, "base_radius": [5.0, 7.0], "amplitude": [1.5, 3.0],
                            "num_clips": 2, "check_videos": 2, "trace_videos": 4},
                "config": {"height": 32, "width": 32}},
    "train": {"traffic": {"batch": 2, "batches": 3},
              "config": {"clip_length": 8, "height": 32, "width": 32}},
}


def run_tiny(workload, seed=2**31 + 5, seconds=1.0, extra=(), root=ROOT):
    """(exit code, the last line's dict or None, standard error) of one
    tiny CPU run of `workload`."""
    kind = "archive" if "archive" in workload else "train"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  *extra], time.perf_counter(), device="cpu", overrides=OVERRIDES[kind],
                 root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

