"""The reader of ``selection.extend_ms_per_batch`` on hand-made records."""

import pytest

from portbench import harness


@pytest.mark.parametrize("ops,ms", [
    # extensions ran: their span's device time a batch
    ({"paris.engine.select": 30000.0, "paris.engine.select.extend": 6000.0,
      "repro_torch::order_range": 7500.0}, 2.0),
    # the list was ordered lazily and never extended
    ({"paris.engine.select": 30000.0, "repro_torch::order_range": 1500.0},
     0.0),
])
def test_extend_reads_the_extension_span_per_batch(ops, ms):
    read = harness.metric_reader("selection.extend_ms_per_batch")
    assert read(dict(ops=ops, counters={"batches": 3})) == pytest.approx(ms)
    live = harness.metric_reader("selection.extend_ms_per_batch.live")
    assert live(dict(ops=ops, counters={"batches": 3})) == pytest.approx(ms)


@pytest.mark.parametrize("ops,counters", [
    # a program that sorts its whole list: only the select span
    ({"paris.engine.select": 24000.0}, {"batches": 2}),
    ({"paris.engine": 5000.0}, {"batches": 2}),  # no selection traced
    ({"paris.engine.select": 5000.0, "paris.engine.select.extend": 900.0,
      "repro_torch::order_range": 1000.0}, {}),  # no batch in the window
])
def test_extend_reads_nothing_without_a_lazy_list_or_a_batch(ops, counters):
    read = harness.metric_reader("selection.extend_ms_per_batch")
    assert read(dict(ops=ops, counters=counters)) is None
