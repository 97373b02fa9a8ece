"""``chip_smoke.py::_device_ms`` counts the records of each profiler
session against the calls it made (ROADMAP Queue C 14): a session that
lost records is run again, and after three short sessions the time is
"not measured" (None), never a short sum. On a stub profile: lists of
(start ns, duration ns, name) records."""

import chip_smoke

# one call of the function under test: two matching launches of 3 us and
# 5 us, and one other kernel
ONE_CALL = [(0, 3000, "void blur_kernel<float>(...)"),
            (0, 5000, "void blur_kernel<float>(...)"),
            (0, 7000, "elementwise_kernel")]
CALLS = 10
PER_CALL_MS = 8000 / 1e6


class Stub:
    """A profile that gives, session by session, the records of the calls
    made with some of them lost: ``lost`` is the number of matching
    records each session drops from its start (the profiler drops a
    session's first records)."""

    def __init__(self, *lost):
        self.lost = list(lost)
        self.sessions = []

    def __call__(self, fn, calls):
        records = ONE_CALL * calls
        drop = self.lost.pop(0) if self.lost else 0
        out, dropped = [], 0
        for rec in records:
            if dropped < drop and "blur" in rec[2]:
                dropped += 1
                continue
            out.append(rec)
        self.sessions.append((calls, len(out)))
        return out


def _ms(stub):
    return chip_smoke._device_ms(lambda: None, "blur_kernel", CALLS, stub)


def test_full_sessions_give_the_time_per_call():
    stub = Stub(0, 0)
    assert _ms(stub) == PER_CALL_MS
    assert [c for c, _ in stub.sessions] == [1, CALLS]


def test_a_session_short_of_records_runs_again():
    stub = Stub(0, 3, 0)
    assert _ms(stub) == PER_CALL_MS
    assert [c for c, _ in stub.sessions] == [1, CALLS, CALLS]


def test_three_short_sessions_are_not_measured():
    """The old reading would have been (20 - 1) records' sum over 10 calls,
    under the true time; now None."""
    assert _ms(Stub(0, 1, 1, 1)) is None


def test_a_lossy_first_call_is_corrected_by_a_full_session():
    """The first traced call lost one of its two records: a session with
    twice the count sets the count per call, and the next must meet it."""
    stub = Stub(1, 0, 0)
    assert _ms(stub) == PER_CALL_MS
    assert [c for c, _ in stub.sessions] == [1, CALLS, CALLS]
    assert _ms(Stub(1, 0, 2, 2)) is None


def test_no_record_at_all_is_not_measured():
    assert _ms(Stub(2, 2, 2)) is None
    assert chip_smoke._matched(ONE_CALL, "blur") == (2, 8000)
