"""The reader of ``engine.device_ops_per_batch`` on hand-made records."""

import pytest

from portbench import harness


def _kernels(n):
    return [(f"op{i}", float(i), float(i) + 0.5) for i in range(n)]


@pytest.mark.parametrize("name", ["engine.device_ops_per_batch.batch",
                                  "engine.device_ops_per_batch.live"])
@pytest.mark.parametrize("n_ops,batches,per_batch", [
    (1070, 1, 1070.0),  # one batch of a hard cell's parent
    (900, 4, 225.0),
    (0, 3, 0.0),  # batches ran and launched nothing on the device
])
def test_device_ops_read_operations_per_batch(name, n_ops, batches,
                                              per_batch):
    read = harness.metric_reader(name)
    record = dict(kernels=_kernels(n_ops), counters={"batches": batches})
    assert read(record) == pytest.approx(per_batch)


@pytest.mark.parametrize("counters", [{}, {"batches": 0}])
def test_device_ops_read_nothing_without_a_batch(counters):
    read = harness.metric_reader("engine.device_ops_per_batch.batch")
    assert read(dict(kernels=_kernels(5), counters=counters)) is None


def test_device_ops_are_reported_in_the_batch_cells():
    """The cells that list the metric report ``queries_per_s``, the
    end-to-end metric it moves, and read it from the traced record."""
    spec = harness.load_spec()
    for name, cells in (("engine.device_ops_per_batch.batch",
                         {"rw-batch-hard", "rw-batch-easy"}),
                        ("engine.device_ops_per_batch.live",
                         {"live-batch-easy"})):
        for cell in cells:
            plan = harness.cell_plan(spec, cell)
            assert name in {m["name"] for m in plan["per_layer"]}
            assert "queries_per_s" in {m["name"] for m in plan["end_to_end"]}
