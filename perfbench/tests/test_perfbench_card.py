"""On the card, at each cell's own size: a short run of the port is
correct, and the control (the reference one precision down, in the port's
place) is not. Run there with ``python -m pytest perfbench/tests -m cuda``."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness import ROOT, Bench, check, measure, verdict

CELLS = [w["name"] for w in Bench(ROOT).spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_port_correct_and_control_not(card, name):
    bench = Bench(ROOT)
    cell = bench.cell(name, 20261017, card, False)
    driver = bench.driver(cell)
    session = driver.Session(cell)
    session.warmup()
    records = measure(session, cell, 3.0)[0]
    session.free()
    ok, compared = verdict(check(session, records, cell), cell.limits)
    assert ok, compared
    ok, compared = verdict(check(session, records, cell, driver.CONTROL), cell.limits)
    assert not ok, compared
    del session, records
    torch.cuda.empty_cache()
