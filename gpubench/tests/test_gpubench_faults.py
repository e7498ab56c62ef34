"""Each fault a cell can have, planted under the timed path, makes the
run's `correct` false; without one it is true.  The run is the driver's
whole run on the CPU at a small size: only the look for a card is
skipped."""
import pytest

from conftest import context, small_cell

CASES = [
    ("shgn-dblp.train", None), ("shgn-dblp.train", "frozen_state"),
    ("shgn-dblp.train", "half_batch"), ("shgn-dblp.train", "altered_answer"),
    ("granite-moe-1b-a400m.train_4k", None), ("granite-moe-1b-a400m.train_4k", "frozen_state"),
    ("granite-moe-1b-a400m.train_4k", "half_batch"),
    ("granite-moe-1b-a400m.prefill_2k", None), ("granite-moe-1b-a400m.prefill_2k", "altered_answer"),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(cell, fault):
    from gbench import harness

    c = small_cell(cell)
    res = harness.driver(c.kind).run(context(c, fault=fault))
    line = harness.result_line(c, res, False, {"platform": "cpu", "kind": "cpu", "count": 1},
                               lambda m: None)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1
