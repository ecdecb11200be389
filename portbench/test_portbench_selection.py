"""The reader of ``selection.ms_per_batch`` on hand-made records."""

import pytest

from portbench import harness


@pytest.mark.parametrize("ops,ms", [
    # the span holds the selection's kernels, topk or not
    ({"paris.engine.select": 24000.0, "aten::topk": 9.0,
      "paris.engine": 90000.0}, 8.0),
    ({"paris.engine.select": 24000.0, "paris.engine": 90000.0}, 8.0),
    # a program that marks no steps: its topk was the selection
    ({"aten::topk": 3000.0}, 1.0),
])
def test_selection_reads_the_select_span_per_batch(ops, ms):
    read = harness.metric_reader("selection.ms_per_batch")
    assert read(dict(ops=ops, counters={"batches": 3})) == pytest.approx(ms)


@pytest.mark.parametrize("ops,counters", [
    ({"paris.engine": 5000.0}, {"batches": 2}),  # no selection traced
    ({"paris.engine.select": 5000.0}, {}),  # no batch in the window
    ({"paris.engine.select": 0.0}, {"batches": 2}),
])
def test_selection_reads_nothing_without_a_selection_or_a_batch(ops,
                                                                 counters):
    read = harness.metric_reader("selection.ms_per_batch")
    assert read(dict(ops=ops, counters=counters)) is None
