"""``chip_smoke.py``'s launch traces (ROADMAP Queue C 24) on stub
profiles: a trace never accepts a short count (``_check_launches`` raises
``ShortTrace`` when every kernel ran at most what was wanted and one ran
less), ``_retried_trace`` runs the body again in a fresh session up to
``TRACE_ATTEMPTS`` times when a trace comes up short and then fails, a
count over ``want`` or wrappers that count otherwise than in the first
attempt fail at once, ``_launch_trace`` counts its session's records by
kernel and between markers, and a traced resume that runs again starts
from the state its first attempt started from."""

import contextlib
import json

import pytest

import chip_smoke

STAGE = "void rdb_stage_tf32<64>(...)"  # five per block forward
DW = "void dw_tf32_kernel(...)"          # one per block backward


def _ran(forwards, backwards=0):
    return {"rdb5c": forwards, "rdb5c_bwd": backwards, "blur": 0}


class StubTrace:
    """Stands for ``_launch_trace``: attempt i yields a trace whose card
    ran ``ran[i]`` and whose wrappers counted ``counted[i]``, checked as
    the real one checks."""

    def __init__(self, ran, counted):
        self.ran, self.counted, self.bodies = list(ran), list(counted), 0
        self.open = False

    @contextlib.contextmanager
    def __call__(self, want, fresh, label):
        out = {}
        self.open = True
        yield out
        self.open = False
        self.bodies += 1
        out.update(ran=self.ran.pop(0), counted=self.counted.pop(0),
                   records=1)
        chip_smoke._check_launches(out, want, fresh, label)


def _retry(stub, want=None):
    want = want or {"rdb5c": 69}
    return chip_smoke._retried_trace(lambda: "done", want, label="x8",
                                     trace=stub)


def test_a_full_trace_is_taken_at_once():
    stub = StubTrace([_ran(69)], [_ran(9)])
    t, result = _retry(stub)
    assert result == "done" and stub.bodies == 1 and t["ran"] == _ran(69)


def test_a_short_trace_runs_the_body_again():
    stub = StubTrace([_ran(60), _ran(69)], [_ran(9), _ran(9)])
    t, _ = _retry(stub)
    assert stub.bodies == 2 and t["ran"] == _ran(69)


def test_three_short_traces_fail():
    stub = StubTrace([_ran(60), _ran(68), _ran(1)], [_ran(9)] * 3)
    with pytest.raises(chip_smoke.ShortTrace, match="x8"):
        _retry(stub)
    assert stub.bodies == chip_smoke.TRACE_ATTEMPTS == 3


def test_a_retry_starts_from_its_setup():
    """A body that advances a state (a trainer's steps and captures)
    starts each attempt from what ``setup`` made for it, outside the
    attempt's session; ``setup`` is told the attempt's number."""
    stub = StubTrace([_ran(60), _ran(69)], [_ran(9)] * 2)
    made = []

    def setup(attempt):
        assert not stub.open
        made.append({"attempt": attempt, "steps": 0})
        return made[-1]

    def body(start):
        assert stub.open
        start["steps"] += 2
        return start

    t, result = chip_smoke._retried_trace(body, {"rdb5c": 69}, label="x",
                                          trace=stub, setup=setup)
    assert stub.bodies == 2 and t["ran"] == _ran(69)
    assert made == [{"attempt": 1, "steps": 2}, {"attempt": 2, "steps": 2}]
    assert result is made[1]


def test_a_trace_over_want_fails_at_once():
    stub = StubTrace([_ran(70), _ran(69)], [_ran(9)] * 2)
    with pytest.raises(AssertionError) as e:
        _retry(stub)
    assert not isinstance(e.value, chip_smoke.ShortTrace)
    assert stub.bodies == 1


def test_short_on_one_kernel_and_over_on_another_fails_at_once():
    stub = StubTrace([_ran(60, 70)], [_ran(9, 9)])
    with pytest.raises(AssertionError) as e:
        _retry(stub, {"rdb5c": 69, "rdb5c_bwd": 69})
    assert not isinstance(e.value, chip_smoke.ShortTrace)


def test_wrappers_that_miscount_fail_at_once():
    stub = StubTrace([_ran(60), _ran(60), _ran(69)],
                     [_ran(9), _ran(8), _ran(9)])
    with pytest.raises(AssertionError, match="attempt 2"):
        _retry(stub)
    assert stub.bodies == 2


def test_an_idle_wrapper_is_no_short_trace():
    out = {"ran": _ran(60), "counted": _ran(0), "records": 1}
    with pytest.raises(AssertionError) as e:
        chip_smoke._check_launches(out, {"rdb5c": 69}, True, "fresh")
    assert not isinstance(e.value, chip_smoke.ShortTrace)
    chip_smoke._check_launches({"ran": _ran(69), "counted": _ran(0),
                                "records": 1}, {"rdb5c": 69}, False, "")


def test_a_trace_counts_its_session(monkeypatch):
    """One profiler session: the trace counts its records by kernel, in
    all and between the markers that the body put between its steps."""
    records = [STAGE] * 5 + [DW, chip_smoke.MARKER] + [STAGE] * 15
    opened = []

    @contextlib.contextmanager
    def profiled(cpu=False):
        opened.append(cpu)
        yield "session"

    monkeypatch.setattr(chip_smoke, "_profiled", profiled)
    monkeypatch.setattr(chip_smoke, "_device_events", lambda prof: [
        (0, 1, name) for name in records])
    monkeypatch.setattr(chip_smoke, "_reset_launches", lambda: None)
    monkeypatch.setattr(chip_smoke, "_counted", lambda: _ran(4, 1))
    with chip_smoke._launch_trace({"rdb5c": 4, "rdb5c_bwd": 1},
                                  label="one") as t:
        pass
    assert opened == [False]
    assert t["ran"] == _ran(4, 1) and t["records"] == len(records)
    assert t["segments"] == [_ran(1, 1), _ran(3)]
    with pytest.raises(chip_smoke.ShortTrace, match="22 device records"):
        with chip_smoke._launch_trace({"rdb5c": 5, "rdb5c_bwd": 1},
                                      label="short"):
            pass


def test_a_retried_resume_starts_from_the_same_state(tmp_path):
    """A resume's trace that comes up short runs the CLI again. The first
    attempt saved a newer state beside the one it resumed from: the
    second must start from the same state (``_resume_state`` names the
    file), where the directory would give it the newer one."""
    from trainner_tpu_torch.train import cli

    states = tmp_path / "exp" / "training_state"
    states.mkdir(parents=True)

    def save(it):
        (states / f"{it}.state").write_bytes(b"")
        (states / f"{it}.state.json").write_text(
            json.dumps({"epoch": it // 2, "iter": it}))

    def opt(resume_state):
        return {"path": {"resume_state": resume_state,
                         "models": str(tmp_path / "exp" / "models")}}

    save(12)
    resume_state = chip_smoke._resume_state(str(tmp_path / "exp"), 12)
    started = []

    def body():  # the resumed CLI: reads its state, saves at 14
        started.append(cli.get_resume_state(opt(resume_state))["iter"])
        save(14)

    stub = StubTrace([_ran(60), _ran(69)], [_ran(9)] * 2)
    chip_smoke._retried_trace(body, {"rdb5c": 69}, label="resume",
                              trace=stub)
    assert stub.bodies == 2 and started == [12, 12]
    assert cli.get_resume_state(opt(str(states)))["iter"] == 14
