"""CPU smoke runs of every bench.py row.

bench.py measures on an NVIDIA GPU; its wiring is exercised here. Each case
runs a row as a subprocess with the tiny-size knobs (--particles / --mag-n /
--sheath-n / --row-steps) under --cpu and validates the JSON contract the
driver parses.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = [
    ("headline", ["--only", "headline", "--steps", "2",
                  "--particles", "8192"]),
    ("two_stream", ["--only", "two_stream", "--row-steps", "10"]),
    ("landau", ["--only", "landau", "--row-steps", "3"]),
    ("sheath", ["--only", "sheath", "--sheath-n", "8192",
                "--row-steps", "5"]),
    ("magnetized", ["--only", "magnetized", "--mag-n", "4096",
                    "--row-steps", "3"]),
    ("domain", ["--only", "domain", "--particles", "16384"]),
    ("domain_explicit", ["--only", "domain_explicit",
                         "--particles", "16384"]),
]


@pytest.mark.parametrize("name,flags", ROWS, ids=[r[0] for r in ROWS])
def test_bench_row_smoke(name, flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu"] + flags,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, f"bench --only {name} failed:\n{out.stderr}"
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert lines, f"no stdout from bench --only {name}:\n{out.stderr}"
    rec = json.loads(lines[-1])
    # the driver contract: one JSON line with exactly these keys, the
    # device it ran on included
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "platform", "device_kind", "device_count", "gpu"}
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    expect = ("particle_pushes_per_sec_per_chip" if name == "headline"
              else f"{name}_pushes_per_sec_per_chip")
    assert rec["metric"] == expect
    assert rec["value"] > 0
    assert rec["unit"] == "pushes/s [cpu]"


def test_bench_default_combined_artifact():
    """The driver default (no --only/--all) prints ONE JSON line: the
    headline row with every other measured matrix row folded in under
    "rows" (each row in its own subprocess, one at a time) and BOTH
    north-star clauses (throughput + drift)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
         "--steps", "2", "--particles", "8192", "--row-steps", "3",
         "--sheath-n", "8192", "--mag-n", "4096", "--drift-steps", "40",
         "--budget-s", "1e8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, f"bench default failed:\n{out.stderr}"
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"default mode must print ONE line:\n{out.stdout}"
    rec = json.loads(lines[0])
    assert rec["metric"] == "particle_pushes_per_sec_per_chip"
    assert rec["value"] > 0
    assert "skipped" not in rec and "failed" not in rec, rec
    expect_rows = {"two_stream", "landau", "sheath", "magnetized",
                   "domain", "domain_explicit"}
    assert set(rec["rows"]) == expect_rows, rec["rows"]
    for name, row in rec["rows"].items():
        assert row["metric"] == f"{name}_pushes_per_sec_per_chip"
        assert row["value"] > 0
        assert row["unit"] == "pushes/s [cpu]"
        assert row["platform"] == "cpu"
    # the accuracy clause rides the same artifact
    assert isinstance(rec["drift_per_1e4"], float)
    assert rec["drift_steps"] == 40
    assert rec["unit"] == "pushes/s [cpu]"


def test_bench_default_budget_skips_rows_not_headline():
    """With no budget left, the non-headline rows AND the drift clause are
    skipped (and listed in the artifact — skipped is never silent-absent)
    but the headline row still runs and is recorded."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
         "--steps", "2", "--particles", "8192", "--budget-s", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, f"bench default failed:\n{out.stderr}"
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "particle_pushes_per_sec_per_chip"
    assert rec["value"] > 0
    assert rec["rows"] == {}
    assert set(rec["skipped"]) == {"two_stream", "landau", "sheath",
                                   "magnetized", "domain", "domain_explicit"}
    assert rec["drift_per_1e4"].startswith("skipped (budget")


def test_bench_row_death_cannot_take_the_tail():
    """The headline row DIES (here by an injected failure; on a card it
    could be an out-of-memory) and every following row must still be
    measured and recorded, because
    each row runs in its own subprocess. Also locks the failure
    attribution contract: "failed" + "failed_detail" carry the row and
    its stderr tail."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYPIC_BENCH_TEST_FAIL_ROW"] = "headline"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
         "--steps", "2", "--particles", "8192", "--row-steps", "3",
         "--sheath-n", "8192", "--mag-n", "4096", "--drift-steps", "0",
         "--budget-s", "1e8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200,
    )
    # headline dead => artifact value 0 and rc 1, but the tail SURVIVES
    assert out.returncode == 1, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] == 0.0
    assert rec["failed"] == ["headline"]
    assert "injected test failure" in rec["failed_detail"]["headline"]
    expect_rows = {"two_stream", "landau", "sheath", "magnetized",
                   "domain", "domain_explicit"}
    assert set(rec["rows"]) == expect_rows, rec
    for row in rec["rows"].values():
        assert row["value"] > 0


def test_bench_sigterm_emits_partial_artifact():
    """A SIGTERM mid-matrix (the driver-timeout scenario) must still
    produce the ONE JSON line with whatever was measured, an explicit
    "interrupted" marker, and the unfinished rows listed as skipped — a
    truncated artifact, never an empty one."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
         "--steps", "2", "--particles", "8192", "--row-steps", "3",
         "--sheath-n", "8192", "--mag-n", "4096", "--drift-steps", "40",
         "--budget-s", "1e8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    # wait for the headline row to land (its stderr line), then interrupt;
    # select() keeps the deadline honest even while the parent is silent
    # (readline alone would block past it if the child wedged)
    import select

    deadline = time.time() + 300
    saw_headline = False
    stderr_lines = []
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 5.0)
        if not ready:
            continue
        ln = proc.stderr.readline()
        if not ln:
            break
        stderr_lines.append(ln)
        if ln.startswith("bench[headline]:"):
            saw_headline = True
            break
    if not saw_headline:
        proc.kill()
        proc.communicate()
        raise AssertionError("".join(stderr_lines)[-2000:])
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 1
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert rec["interrupted"] == "SIGTERM"
    assert rec["value"] > 0  # the completed headline row survived
    # everything not yet measured is accounted for, never silently absent
    assert set(rec.get("skipped", [])) | set(rec["rows"]) | \
        set(rec.get("failed", [])) == {
            "two_stream", "landau", "sheath", "magnetized",
            "domain", "domain_explicit"}


def test_bench_drift_only_child_contract():
    """`--only headline --drift-only` (the default mode's drift child)
    emits the machine-readable drift record and NOT a throughput row."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu",
         "--only", "headline", "--drift-only", "--drift-steps", "20",
         "--particles", "4096", "--steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    recs = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert len(recs) == 1, out.stdout
    rec = recs[0]
    assert rec["metric"] == "headline_energy_drift"
    assert rec["drift_steps"] == 20
    assert rec["drift_per_1e4"] == rec["drift"] * 1e4 / 20

