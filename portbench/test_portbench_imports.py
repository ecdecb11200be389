"""What the harness loads: never JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), and the reference side
loads nothing of the program. Checked in fresh processes."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT

RUN_CELLS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
spec = harness.load_spec()
plans = [harness.cell_plan(spec, c) for c in {cells!r}]
for plan in plans:
    over = {{"cfg": {{"num_series": 2048}},
            "traffic": {{"pool": 128, "sample": 8}}}}
    result = harness.run_cell(plan, 3, 0.1, True, device="cpu",
                              overrides=over)
    assert result["correct"], result
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import portbench.control, portbench.cost, portbench.datagen, portbench.judge
import portbench.reference.bruteforce
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    cells = [w["name"] for w in harness.load_spec()["workloads"]]
    mods = _modules(RUN_CELLS.format(root=str(ROOT), src=str(ROOT / "src"),
                                     cells=cells))
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


def test_the_reference_side_loads_nothing_of_the_program():
    mods = _modules(REFERENCE_ONLY.format(root=str(ROOT)))
    assert "torch" in mods
    assert not mods & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rw-batch-hard",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert not pathlib.Path(tmp_path / "src").exists()


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jaxlib.xla", "flax", "jax", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]
