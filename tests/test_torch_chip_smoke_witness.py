"""``chip_smoke.py``'s f64 witnesses on the CPU, with the card's side
played by the CPU: ``_three_ways`` runs the CPU's replay of its branches
only where they differ from the card's (else the card's replay is the
same f64 run, and its readings are those of a run made anew), and
``_same_records`` tells branch records apart. Also the wall-time parts
(``_time_parts``, ``_print_parts``) that a whole run prints."""

import numpy as np
import pytest
import torch

import chip_smoke

ROWS = 12


def _input(seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((ROWS, 8)))


def _run_factory(flip_on_card: bool, calls: list):
    """``run(side)`` of a relu loss; the card's side sees its input with
    one element's sign flipped when ``flip_on_card``, so its branches
    differ from the CPU's in that element."""
    base = _input(0)

    def run(side):
        calls.append(side)
        x = base.clone()
        if side == "cuda" and flip_on_card:
            x[0, 0] = -x[0, 0]
        dtype = torch.float64 if side == "f64" else torch.float32
        x = x.to(dtype).requires_grad_(True)
        value = (torch.relu(x) * torch.arange(8, dtype=dtype)).sum()
        (grad,) = torch.autograd.grad(value, x)
        return value, grad

    return run


@pytest.mark.parametrize("flip_on_card", [False, True])
def test_three_ways_runs_the_cpu_replay_only_where_branches_differ(
        flip_on_card):
    calls = []
    r = chip_smoke._three_ways("relu", _run_factory(flip_on_card, calls),
                               "stub card")
    assert calls.count("f64") == (3 if flip_on_card else 2)
    # the CPU's own witness read as a fresh replay of its branches reads
    cpu_calls = []
    run = _run_factory(flip_on_card, cpu_calls)
    with chip_smoke._Branches() as rec:
        _, g_cpu = run("cpu")
    with chip_smoke._Branches(rec.records), chip_smoke._in_f64():
        _, g_f64 = run("f64")
    want = chip_smoke._rel(g_cpu.double(), g_f64.double())
    assert r["cpu_own_f64"] == want
    assert r["value"] <= chip_smoke.LOSS_VALUE_TOL or flip_on_card


def test_same_records_tells_branches_apart():
    x = _input(1)
    with chip_smoke._Branches() as a:
        torch.relu(x)
        torch.abs(x)
    with chip_smoke._Branches() as b:
        torch.relu(x)
        torch.abs(x)
    y = x.clone()
    y[3, 2] = -y[3, 2]
    with chip_smoke._Branches() as c:
        torch.relu(y)
        torch.abs(y)
    assert chip_smoke._same_records(a.records, b.records)
    assert not chip_smoke._same_records(a.records, c.records)
    assert not chip_smoke._same_records(a.records, b.records[:1])
    assert not chip_smoke._same_records(a.records, None)


def test_parts_add_up_by_phase(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "PARTS", type(chip_smoke.PARTS)(
        chip_smoke.PARTS.default_factory))
    monkeypatch.setattr(chip_smoke, "SESSIONS", [(0.5, 0.25)])

    def phase_stub(smi):
        chip_smoke._time_ms_stub(smi)
        chip_smoke._time_ms_stub(smi)

    def _time_ms_stub(smi):
        return smi

    monkeypatch.setattr(chip_smoke, "phase_stub", phase_stub, raising=False)
    monkeypatch.setattr(chip_smoke, "_time_ms_stub", _time_ms_stub,
                        raising=False)
    phase_stub.__module__ = _time_ms_stub.__module__ = "chip_smoke"
    saved = dict(vars(chip_smoke))
    try:
        chip_smoke._time_parts()
        chip_smoke.phase_stub("card")
    finally:
        for name, fn in saved.items():
            setattr(chip_smoke, name, fn)
    assert chip_smoke.PARTS["phase_stub"][1] == 1
    assert chip_smoke.PARTS["phase_stub/_time_ms_stub"][1] == 2
    chip_smoke._print_parts("card")
    out = capsys.readouterr().out
    assert "1 profiler sessions, 0.5 s to open" in out
    assert "phase_stub/_time_ms_stub" in out
