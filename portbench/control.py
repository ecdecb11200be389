"""The control of ``correct``: the reference put in the program's place,
computed one precision below the configurations' float32 (bfloat16), and
judged as a run judges the program. It has to come out not correct.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

runs at the cell's own size on the card (it needs no program: the
collection and the queries come from ``datagen``, the answers from
``reference``), and prints one JSON line a seed with the compared numbers;
then the same for a planted fault, the float32 reference with every answer
moved to the next series, which ``pos_gap`` has to catch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

if __package__ in (None, ""):
    sys.path[:1] = [str(pathlib.Path(__file__).resolve().parent.parent)]

from portbench import datagen, judge  # noqa: E402
from portbench.harness import cell_plan, load_spec, plugin  # noqa: E402


def _inputs(plan: dict, seed: int, device) -> tuple:
    """The sampled queries of a run of ``seed`` and the collection's
    chunks, as a run makes them."""
    cfg, traffic = plan["cfg"], plan["traffic"]
    num, n = int(cfg["num_series"]), int(cfg["series_length"])
    raw = datagen.collection(num, n, seed, device)
    queries = datagen.queries(traffic, n, seed, device, raw=raw)
    del raw
    sel = datagen.sample(queries.shape[0], traffic["sample"], seed)
    qs = queries[torch.as_tensor(sel, device=queries.device)]

    def chunks():
        return datagen.collection_chunks(num, n, seed, device)
    return qs, chunks, int(traffic["k"])


def control_values(plan: dict, seed: int, device) -> dict:
    """The compared numbers of the bfloat16 reference on ``seed``: a sample
    of the cell's queries, as many as a run checks."""
    qs, chunks, k = _inputs(plan, seed, device)
    ref = plugin("reference", plan["cfg"]["reference"])
    d, p, _ = ref.knn(chunks(), qs, k, dtype=torch.bfloat16)
    ref_d, _, probe_d = ref.knn(chunks(), qs, k, probe=p)
    values = judge.numbers(d.cpu().numpy(), p.cpu().numpy(),
                           ref_d.cpu().numpy(), probe_d.cpu().numpy(), 0)
    values["sampled"] = int(qs.shape[0])
    return values


def altered_values(plan: dict, seed: int, device) -> dict:
    """The compared numbers of a planted fault: the float32 reference in
    the program's place with every answer moved to the next series of the
    collection (an answer altered where it is produced)."""
    qs, chunks, k = _inputs(plan, seed, device)
    ref = plugin("reference", plan["cfg"]["reference"])
    d, p, _ = ref.knn(chunks(), qs, k)
    p = (p + 1) % int(plan["cfg"]["num_series"])
    ref_d, _, probe_d = ref.knn(chunks(), qs, k, probe=p)
    values = judge.numbers(d.cpu().numpy(), p.cpu().numpy(),
                           ref_d.cpu().numpy(), probe_d.cpu().numpy(), 0)
    values["sampled"] = int(qs.shape[0])
    return values


def main(argv=None) -> int:
    """Run the control of one cell on the given seeds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    plan = cell_plan(load_spec(), args.workload)
    for seed in args.seeds:
        for what, fn in (("bf16_control", control_values),
                         ("altered_answer", altered_values)):
            values = fn(plan, seed, "cuda:0")
            correct, _ = judge.verdict(values, plan["cfg"]["limits"])
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  run=what, correct=correct, **values)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
