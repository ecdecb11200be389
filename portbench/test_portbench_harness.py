"""The harness on the CPU: every cell's files load by name, the traffic
follows the seed, each cell runs end to end at a tiny size and is correct,
and ``BENCHMARK.json`` keeps to its contract's shape."""

import json
import pathlib
import re

import pytest
import torch

from portbench import datagen, harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAFFIC = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 12345  # larger than 32 signed bits hold


def plan(cell):
    """The plan of a cell of BENCHMARK.json."""
    return harness.cell_plan(SPEC, cell)


def tiny(cell) -> dict:
    """Sizes a CPU test holds: 4096 series, a small pool and sample."""
    return {"cfg": {"num_series": 4096},
            "traffic": {"pool": 256, "sample": 16}}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    want = plan(cell)
    cfg, traffic = want["cfg"], want["traffic"]
    entry = next(c for c in SPEC["configs"] if c["name"] == cfg["name"])
    root = harness.ROOT
    assert (root / entry["file"]).resolve() == (
        harness.HERE / "configs" / f"{cfg['name']}.json").resolve()
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for part in ("deploy",):
        assert callable(getattr(
            harness.plugin("deployments", cfg["deployment"]), part))
    loop = harness.plugin("loops", traffic["loop"])
    assert callable(loop.warm) and callable(loop.run)
    assert callable(harness.plugin("reference", cfg["reference"]).knn)
    assert traffic["queries"] in datagen.QUERY_KINDS
    assert want["per_layer"], "every cell reports a per-layer metric"
    for m in want["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    names = {m["name"] for m in want["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    if "k" in cfg:
        assert int(cfg["k"]) == int(traffic["k"])


def test_every_harness_file_loads():
    """Every configuration, mix, kind and reader under the harness loads,
    and each is named by some cell."""
    named = {part: {plan(c)[part]["name" if part == "cfg" else "loop"]
                    for c in CELLS} for part in ("cfg", "traffic")}
    for path in (harness.HERE / "configs").glob("*.json"):
        cfg = harness.read_json("configs", path.stem)
        assert cfg["name"] == path.stem and path.stem in named["cfg"]
        harness.plugin("deployments", cfg["deployment"])
        harness.plugin("reference", cfg["reference"])
    cells = {w["traffic"] for w in SPEC["workloads"]}
    for name in TRAFFIC:
        assert name in cells
        harness.plugin("loops", harness.read_json("traffic", name)["loop"])
    readers = set()
    for m in SPEC["per_layer"]:
        readers.add(harness.metric_reader(m["name"]).__module__)
    for path in (harness.HERE / "metrics").glob("*.py"):
        assert callable(harness.metric_reader(path.stem))
        assert harness.metric_reader(path.stem).__module__ in readers


def test_a_dotted_name_is_read_as_its_quantity():
    assert harness.quantities("a.b.c") == ["a.b.c", "a.b", "a"]
    idle = harness.metric_reader("device.idle_pct")
    for cell in ("batch", "single"):
        reader = harness.metric_reader(f"device.idle_pct.{cell}")
        assert reader.__module__ == idle.__module__
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such.metric")


def test_benchmark_json_keeps_its_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 + 14 * 24 * 60  # the contract's 24-cell budget, rounded
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in SPEC[part]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_queries_follow_the_seed(traffic):
    t = dict(harness.read_json("traffic", traffic), pool=32)
    raw = datagen.collection(1024, 256, SEED, "cpu")
    a = datagen.queries(t, 256, SEED, "cpu", raw=raw)
    b = datagen.queries(t, 256, SEED, "cpu", raw=raw)
    c = datagen.queries(t, 256, SEED + 1, "cpu", raw=raw)
    assert a.shape == (32, 256) and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_collection_follows_the_seed_chunk_by_chunk(monkeypatch):
    monkeypatch.setattr(datagen, "WALK_CHUNK", 300)
    whole = datagen.collection(1000, 16, SEED, "cpu")
    again = torch.cat([c for _, c in datagen.collection_chunks(
        1000, 16, SEED, "cpu")])
    assert torch.equal(whole, again)
    assert not torch.equal(whole, datagen.collection(1000, 16, 7, "cpu"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu_and_is_correct(cell, trace):
    result = harness.run_cell(
        plan(cell), SEED, 0.2, bool(trace), device="cpu",
        overrides=tiny(cell))
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    want = plan(cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in want["per_layer"]}
        assert set(result["metrics"]) <= allowed
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in want["end_to_end"]}
        for v in result["metrics"].values():
            assert v["value"] > 0
    json.dumps(harness.finite(result), allow_nan=False)


BATCH_CELLS = [c for c in CELLS
               if plan(c)["traffic"]["loop"] == "closed_batch"]


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_the_rate_is_every_query_over_the_whole_window(cell):
    result = harness.run_cell(plan(cell), SEED, 0.2, False, device="cpu",
                              overrides=tiny(cell))
    c = result["counters"]
    assert c["queries"] == c["batches"] * c["batch"] == result["attempted"]
    assert c["window_s"] >= 0.2
    rate = next(v["value"] for k, v in result["metrics"].items()
                if k.startswith("queries_per_s"))
    assert rate == pytest.approx(c["queries"] / c["window_s"])


def test_a_traced_run_drives_at_most_its_trace_seconds():
    cell = "rw-batch-hard"
    over = tiny(cell)
    over["traffic"]["trace_seconds"] = 0.05
    traced = harness.run_cell(plan(cell), SEED, 60.0, True, device="cpu",
                              overrides=over)
    assert traced["correct"] is True
    # The window closes after the batch that passes trace_seconds, the
    # first, however long a batch takes on a loaded host.
    assert traced["counters"]["batches"] == 1
    assert "engine.rounds_per_batch.batch" in traced["metrics"]
    assert set(traced["metrics"]) <= {m["name"]
                                      for m in plan(cell)["per_layer"]}


def test_gitignore_keeps_the_cache_out():
    lines = (pathlib.Path(harness.HERE) / ".gitignore").read_text().split()
    assert ".cache/" in lines
