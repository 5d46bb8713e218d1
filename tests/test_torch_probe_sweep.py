"""The probe's ``--all`` sweep against the reference's, and the dry-run's
sweep through the runner the two now share, on the CPU.

Every child is a stand-in for ``subprocess.run`` (``FakeRun``): most cells
succeed, one fails with more output than the tails keep, one succeeds
without printing; no cell is probed for real.

- ``launch/probe.py``'s ``sweep`` against ``repro.launch.probe.sweep`` over
  the same stand-in results, with ``only_failed`` False and True (records
  planted for a few cells): the printed lines, the ``.FAILED`` files (names
  and bytes), the returned failures and the children's arguments are
  equal, the module name aside. The reference's sweep runs in a
  subprocess, since importing its module sets ``XLA_FLAGS``,
  ``REPRO_SCAN_UNROLL`` and ``REPRO_FORCE_REF_ATTN``, which must not reach
  this process.
- A cell that hangs (the stand-in raises ``TimeoutExpired``) fails alone,
  on the port's sweep only: the reference's has no time limit.
- ``main``: ``--all`` and ``--only-failed``, exit 1 while a failure
  remains, ``--arch`` and ``--shape`` required only without ``--all``.
- ``launch/dryrun.py``'s sweep prints and writes what it did before the
  runner was shared: each child's last line, or ``[dryrun] FAIL <tag>
  (log: <tag>.FAILED)`` with the last 4000 characters of its stdout and
  8000 of its stderr, then the summary line, at 1 and 3 jobs.

Records and ``.FAILED`` files go to ``tmp_path``; nothing is written under
``benchmarks/``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.config import cells
from repro_torch.launch import dryrun, probe

ROOT = Path(__file__).resolve().parents[1]
CELLS = [f"{a}__{s}" for a, s in cells()]
# the stand-in results: one failure, one silent success, the rest succeed
PLAN = {CELLS[2]: "fail", CELLS[5]: "silent"}
# records planted for --only-failed (the failing cell has none)
RECORDED = (CELLS[0], CELLS[1], CELLS[7])


class FakeRun:
    """A stand-in for ``subprocess.run`` of a sweep's child: each cell's
    outcome by its tag from ``plan`` ("ok" where absent, "fail", "silent"
    or "timeout"); the children's argument lists and time limits are kept
    in ``calls``."""

    def __init__(self, plan):
        self.plan, self.calls = plan, []

    def __call__(self, cmd, **kw):
        arch, shape = (cmd[cmd.index(f) + 1] for f in ("--arch", "--shape"))
        tag = f"{arch}__{shape}"
        self.calls.append([cmd[1:], kw.get("timeout")])
        how = self.plan.get(tag, "ok")
        if how == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
        if how == "silent":
            return subprocess.CompletedProcess(cmd, 0, "  \n", "")
        out = "".join(f"{tag}: depth {i} counted\n" for i in range(200))
        if how == "fail":
            err = "".join(f"  File \"step.py\", line {i}, in {tag}\n"
                          for i in range(400))
            return subprocess.CompletedProcess(cmd, 1, out,
                                               err + "RuntimeError: boom\n")
        return subprocess.CompletedProcess(
            cmd, 0, out + f"[probe] {tag}: flops/chip 1.000e+12\n", "")


def read_dir(path):
    return {p.name: p.read_text() for p in sorted(Path(path).iterdir())}


def plant_records(path):
    for tag in RECORDED:
        (Path(path) / f"{tag}.json").write_text("{}")


REFERENCE_SWEEP = """
import contextlib, io, json, subprocess, sys
sys.path.insert(0, {tests!r})
from test_torch_probe_sweep import FakeRun
import repro.launch.probe as probe
fake = FakeRun(json.loads({plan!r}))
subprocess.run = fake
probe.PROBE_DIR = {out!r}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    failures = probe.sweep({only_failed!r})
json.dump({{"lines": buf.getvalue().splitlines(), "failures": failures,
           "calls": fake.calls}}, sys.stdout)
"""


def reference_sweep(out, only_failed):
    """``repro.launch.probe.sweep`` over ``PLAN``'s stand-in results, in a
    subprocess: (printed lines, failures, the children's calls)."""
    code = REFERENCE_SWEEP.format(tests=str(ROOT / "tests"),
                                  plan=json.dumps(PLAN), out=str(out),
                                  only_failed=only_failed)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600, check=True)
    got = json.loads(r.stdout)
    return got["lines"], got["failures"], got["calls"]


def port_sweep(monkeypatch, capsys, out, only_failed, plan=PLAN):
    fake = FakeRun(plan)
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr(probe, "PROBE_DIR", Path(out))
    failures = probe.sweep(only_failed)
    return capsys.readouterr().out.splitlines(), failures, fake.calls


@pytest.mark.parametrize("only_failed", [False, True])
def test_probe_sweep_equals_the_reference(only_failed, monkeypatch, capsys,
                                          tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        d.mkdir()
        if only_failed:
            plant_records(d)
    want = reference_sweep(ref_dir, only_failed)
    got = port_sweep(monkeypatch, capsys, port_dir, only_failed)
    assert got[0] == want[0]                       # the printed lines
    assert got[1] == want[1] == [CELLS[2]]         # the failures
    assert read_dir(port_dir) == read_dir(ref_dir)  # .FAILED and records
    assert f"{CELLS[2]}.FAILED" in read_dir(port_dir)
    # the same children, in order, but for the module and the time limit
    assert [c for c, _ in got[2]] == [
        [a.replace("repro.", "repro_torch.") for a in c] for c, _ in want[2]]
    assert {t for _, t in want[2]} == {None}
    assert {t for _, t in got[2]} == {dryrun.CELL_TIMEOUT_S}
    skipped = set(RECORDED) if only_failed else set()
    assert len(got[2]) == len(CELLS) - len(skipped)
    assert got[0][-1] == f"[probe] sweep done; 1 failures: ['{CELLS[2]}']"
    assert f"[probe] FAIL {CELLS[2]}" in got[0]
    assert CELLS[5] in got[0]                      # the silent child's tag


def test_probe_sweep_timeout_fails_its_cell_alone(monkeypatch, capsys,
                                                  tmp_path):
    plan = {CELLS[3]: "timeout"}
    lines, failures, calls = port_sweep(monkeypatch, capsys, tmp_path,
                                        False, plan)
    assert failures == [CELLS[3]] and len(calls) == len(CELLS)
    assert lines[3] == f"[probe] FAIL {CELLS[3]}"
    assert read_dir(tmp_path) == {
        f"{CELLS[3]}.FAILED":
        f"timed out after {dryrun.CELL_TIMEOUT_S} s"}
    assert lines[4] == f"[probe] {CELLS[4]}: flops/chip 1.000e+12"


@pytest.mark.parametrize("plan,code", [({}, 0), (PLAN, 1)])
def test_probe_main_all_exit_code(plan, code, monkeypatch, capsys,
                                  tmp_path):
    fake = FakeRun(plan)
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr(probe, "PROBE_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        probe.main(["--all"])
    assert e.value.code == code and len(fake.calls) == len(CELLS)
    plant_records(tmp_path)
    with pytest.raises(SystemExit) as e:
        probe.main(["--all", "--only-failed"])
    assert e.value.code == code
    assert len(fake.calls) == 2 * len(CELLS) - len(RECORDED)
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        f"[probe] sweep done; {code} failures")


def test_probe_main_needs_a_cell_without_all(capsys):
    with pytest.raises(SystemExit) as e:
        probe.main(["--arch", "qwen2-0.5b"])
    assert e.value.code == 2
    assert "--arch and --shape are required" in capsys.readouterr().err


@pytest.mark.parametrize("jobs", [1, 3])
def test_dryrun_sweep_prints_and_writes_as_before(jobs, monkeypatch, capsys,
                                                  tmp_path):
    plan = {**PLAN, CELLS[9]: "timeout"}
    fake = FakeRun(plan)
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    failures = dryrun.sweep(jobs=jobs)
    lines = capsys.readouterr().out.splitlines()
    want, files = [], {}
    for tag in CELLS:
        how = plan.get(tag, "ok")
        if how in ("fail", "timeout"):
            want.append(f"[dryrun] FAIL {tag} (log: {tag}.FAILED)")
        elif how == "silent":
            want.append(tag)
        else:
            want.append(f"[probe] {tag}: flops/chip 1.000e+12")
    arch, shape = CELLS[2].split("__")
    bad = FakeRun(plan)(["python", "-m", "m", "--arch", arch, "--shape",
                         shape])
    files[f"{CELLS[2]}.FAILED"] = \
        bad.stdout[-4000:] + "\n" + bad.stderr[-8000:]
    files[f"{CELLS[9]}.FAILED"] = \
        f"timed out after {dryrun.CELL_TIMEOUT_S} s"
    assert failures == [CELLS[2], CELLS[9]]
    assert lines == want + [f"[dryrun] sweep done; 2 failures: "
                            f"{[CELLS[2], CELLS[9]]}"]
    assert read_dir(tmp_path) == files
    assert sorted(c[3] + "__" + c[5] for c, _ in fake.calls) == sorted(CELLS)
    assert all(c[:3] == ["-m", "repro_torch.launch.dryrun", "--arch"]
               and t == dryrun.CELL_TIMEOUT_S for c, t in fake.calls)
