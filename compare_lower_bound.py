#!/usr/bin/env python3
"""Time the port's lower-bound kernels against another build of ``lower_bound.cu``.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 compare_lower_bound.py --baseline OTHER/lower_bound.cu \\
        [--seed 0] [--log2-n 24] [--queries 64]

``OTHER/lower_bound.cu`` is a one-file source with the three C entries as
they were before the launch shape became their arguments (for example
``git show d847d19:src/repro_torch/kernels/csrc/lower_bound.cu``:
:data:`BASELINE_SIGNATURES`). It is compiled with the port's own ``nvcc``
flags into a library of its own beside the port's build. The port's side
launches at the shapes its tuning table resolves; with
``REPRO_TORCH_TUNING_PATH`` set to a missing file it launches its defaults,
the baseline's shapes. Both are driven on ``chip_smoke.py``'s full-size inputs: the index
built from ``--seed`` (N = 2**log2_n random walks, n = 256, w = 16), the Q
query PAAs, and a packed buffer of the same SAX rows cut into the five
components of ``chip_smoke.component_sizes`` in 128-row blocks. For each
entry (``lower_bound_sq_batch``, ``lower_bound_sq_multi`` and
``lower_bound_sq``) the two outputs must be bitwise equal, and the two
builds are timed with CUDA events in turns: baseline, port, port,
baseline, while ``nvidia-smi`` samples the SM clock. With ``cuobjdump`` it
also prints both builds' inner-loop instructions per (query, row) pair
and, for the batch entries, the share of the card's issue rate (one warp
instruction a clock in each of the 528 schedulers) that the loop reaches.
For the single query, which is bound by bytes, it prints each build's
share of its bound (the bytes it must move over 3.35 TB/s), and times both
builds again on three SAX inputs of the same shape whose symbols set how a
warp's table lookups fall on shared-memory banks (``symbol_patterns``):
without a profiler on the card, that is how a build's cost from bank
conflicts shows. The last lines are a JSON object of the times and shares
and the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import pathlib
import statistics
import subprocess
import sys

import chip_smoke as cs

# Launches per timed turn: each turn lasts 0.1-0.2 s, so that nvidia-smi
# reads the SM clock a few times in each.
ITERS = {"lower_bound_sq_batch": 50, "lower_bound_sq_multi": 50,
         "lower_bound_sq": 400}
# The batch entries' instantiations, whose inner loops the issue rate is
# read against (the single query is bound by bytes).
FORMS = {"lower_bound_sq_batch": "batch", "lower_bound_sq_multi": "masked"}
SUBPARTITIONS = 132 * 4  # H100 SXM: 132 SMs of 4 schedulers
_VP, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# The baseline's C entries (the one-file lower_bound.cu, launch shapes fixed
# inside): qpaa, sax, bp_padded, [block_len,] out, [Q,] N, w, n_bp_padded,
# [block_n,] scale, stream.
BASELINE_SIGNATURES = {
    "lower_bound_sq_batch_launch": (_VP, _VP, _VP, _VP, _I, _L, _I, _I, _F,
                                    _VP),
    "lower_bound_sq_launch": (_VP, _VP, _VP, _VP, _L, _I, _I, _F, _VP),
    "lower_bound_sq_multi_launch": (_VP, _VP, _VP, _VP, _VP, _I, _L, _I, _I,
                                    _I, _F, _VP),
}


@contextlib.contextmanager
def sm_clocks(samples: list):
    """Append the SM clock (MHz) that ``nvidia-smi`` reads every 50 ms
    while the block runs; the sampler is stopped on the way out."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        samples += [float(x) for x in out.split() if x.strip().isdigit()]


def build_baseline(source: pathlib.Path):
    """Compile ``source`` alone into a shared library; (library, ptxas log)."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"baseline-{source.stem}.so"
    out = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", str(source),
         "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{out.stdout}")
    lib = ctypes.CDLL(str(so))
    for name in ITERS:
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = list(BASELINE_SIGNATURES[f"{name}_launch"])
        fn.restype = ctypes.c_int
    return lib, so, out.stdout


def packed_rows(sax, sizes, block):
    """The rows of ``sax`` cut into components of ``sizes``, each padded to
    whole ``block``-row blocks; (packed SAX, block_len)."""
    import torch

    parts, lens, start = [], [], 0
    for m in sizes:
        pad = (-m) % block
        parts += [sax[start:start + m], sax.new_zeros((pad, sax.shape[1]))]
        blk = [block] * ((m + pad) // block)
        blk[-1] = block - pad
        lens += blk
        start += m
    return (torch.cat(parts), torch.tensor(lens, dtype=torch.int32,
                                           device=sax.device))


def symbol_patterns(sax, gen) -> dict:
    """The single query's SAX inputs: the index's own rows (leaf order) and
    three of their shape. Row r is lane r % 32 of its warp, so each column
    gives a warp's 32 table lookups: ``uniform``, random symbols;
    ``broadcast``, one symbol for all 32 lanes (a new one each warp and
    column), which no table layout serves with a conflict; ``one_bank``,
    symbols 32k, which a single shared table serves from one bank, eight
    distinct addresses a lookup, the worst case."""
    import torch

    n, w = sax.shape
    r = torch.arange(n, device=sax.device)[:, None]
    j = torch.arange(w, device=sax.device)[None, :]
    uniform = torch.randint(0, 256, (n, w), generator=gen,
                            device=sax.device, dtype=torch.int32)
    return {"leaf_order": sax, "uniform": uniform.to(torch.uint8),
            "broadcast": ((r // 32 * 7 + j) % 256).to(torch.uint8),
            "one_bank": ((r * 3 + j) % 8 * 32).to(torch.uint8)}


def in_turns(old, new, iters: int) -> tuple:
    """Mean ms of ``old`` and ``new`` timed in turns (old, new, new, old)
    and the median SM clock (MHz, None without samples) meanwhile."""
    clocks = []
    with sm_clocks(clocks):
        turns = [cs.time_ms(old, iters), cs.time_ms(new, iters),
                 cs.time_ms(new, iters), cs.time_ms(old, iters)]
    return turns, statistics.median(clocks) if clocks else None


def compare(args, dev, base, per_pair) -> dict:
    """Check and time each entry of the library ``base`` against the port's
    on ``dev``; returns the times by entry. ``per_pair`` holds the SASS
    inner loops' instructions per (query, row) pair, for the port and the
    baseline, by ``lb_instance`` name, where ``cuobjdump`` gave them."""
    import torch

    from repro_torch.core import build_index, isax
    from repro_torch.core.search import DEFAULT_PACK_BLOCK
    from repro_torch.kernels import ops

    n_series, n, w = 1 << args.log2_n, 256, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    raw = cs.random_walks(n_series, n, gen, dev)
    queries = cs.random_walks(args.queries, n, gen, dev)
    index = build_index(raw, device=dev)
    del raw
    qps = isax.paa(isax.znorm(queries), w)
    qp1 = qps[0].contiguous()
    bpp = isax.padded_breakpoints(index.cardinality, dev)
    block = DEFAULT_PACK_BLOCK
    psax, block_len = packed_rows(index.sax, cs.component_sizes(n_series),
                                  block)
    scale = n / w
    n_q = qps.shape[0]

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def old_batch():
        out = torch.empty((n_q, n_series), device=dev)
        cs.expect(base.lower_bound_sq_batch_launch(
            qps.data_ptr(), index.sax.data_ptr(), bpp.data_ptr(),
            out.data_ptr(), n_q, n_series, w, bpp.numel(), scale,
            stream()) == 0, "baseline batch launch")
        return out

    def old_multi():
        out = torch.empty((n_q, psax.shape[0]), device=dev)
        cs.expect(base.lower_bound_sq_multi_launch(
            qps.data_ptr(), psax.data_ptr(), bpp.data_ptr(),
            block_len.data_ptr(), out.data_ptr(), n_q, psax.shape[0], w,
            bpp.numel(), block, scale, stream()) == 0,
            "baseline multi launch")
        return out

    def old_single(sax=index.sax):
        out = torch.empty((n_series,), device=dev)
        cs.expect(base.lower_bound_sq_launch(
            qp1.data_ptr(), sax.data_ptr(), bpp.data_ptr(),
            out.data_ptr(), n_series, w, bpp.numel(), scale,
            stream()) == 0, "baseline single launch")
        return out

    entries = {
        "lower_bound_sq_batch": (old_batch, lambda: ops.lower_bound_sq_batch(
            qps, index.sax, bpp, n)),
        "lower_bound_sq_multi": (old_multi, lambda: ops.lower_bound_sq_multi(
            qps, psax, bpp, n, block_len, block_n=block)),
        "lower_bound_sq": (old_single, lambda: ops.lower_bound_sq(
            qp1, index.sax, bpp, n)),
    }
    cs.log(f"[compare] N={n_series} N_pad={psax.shape[0]} Q={n_q} w={w}; "
           f"baseline {args.baseline}")
    result = {}
    for name, (old, new) in entries.items():
        a, b = old(), new()
        torch.cuda.synchronize()
        cs.expect(torch.equal(a, b), f"{name}: baseline and port outputs "
                  "are not bitwise equal")
        del a, b
        turns, mhz = in_turns(old, new, ITERS[name])
        t_old, t_new = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        cs.log(f"[compare] {name}: baseline {turns[0]:.4f} / {turns[3]:.4f} "
               f"ms, port {turns[1]:.4f} / {turns[2]:.4f} ms; port/baseline "
               f"{t_new / t_old:.3f}; outputs bitwise equal; SM clock "
               f"median {mhz} MHz")
        result[name] = dict(baseline_ms=[turns[0], turns[3]],
                            port_ms=[turns[1], turns[2]],
                            ratio=t_new / t_old, sm_mhz=mhz)
        if name == "lower_bound_sq":
            b_ms, b_by = cs.bound_ms(
                index.sax.numel() + bpp.numel() * 4 + w * 4 + n_series * 4,
                n_series * (6 * w + 1))
            result[name]["bound_ms"] = b_ms
            for who, t in (("port", t_new), ("baseline", t_old)):
                cs.log(f"[compare] {name} {who}: {100 * b_ms / t:.1f}% of "
                       f"its {b_ms:.4f} ms bound (by {b_by})")
                result[name][f"{who}_bound_share"] = b_ms / t
        if name not in FORMS or mhz is None:
            continue
        for who, t in (("port", t_new), ("baseline", t_old)):
            inst = per_pair[who].get(f"lb_kernel<w={w}, {FORMS[name]}>")
            if inst is None:
                continue
            # Pairs computed: pad rows of the packed form take none.
            rate = n_q * n_series * inst / 32 / (t * 1e-3)
            ceiling = SUBPARTITIONS * mhz * 1e6
            cs.log(f"[compare] {name} {who}: the inner loop issues "
                   f"{rate / 1e12:.4f} T warp instructions/s, "
                   f"{100 * rate / ceiling:.1f}% of one a clock per "
                   f"scheduler at {mhz} MHz")
            result[name][f"{who}_issue_share"] = rate / ceiling

    single = result["lower_bound_sq"]
    single["patterns"] = {}
    for pat, sax in symbol_patterns(index.sax, gen).items():
        old = functools.partial(old_single, sax)
        new = functools.partial(ops.lower_bound_sq, qp1, sax, bpp, n)
        cs.expect(torch.equal(old(), new()), f"lower_bound_sq on {pat} "
                  "symbols: baseline and port outputs are not bitwise equal")
        turns, mhz = in_turns(old, new, ITERS["lower_bound_sq"])
        t_old, t_new = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        share = single["bound_ms"] / t_old, single["bound_ms"] / t_new
        cs.log(f"[compare] lower_bound_sq on {pat} symbols: baseline "
               f"{t_old:.4f} ms ({100 * share[0]:.1f}% of bound), port "
               f"{t_new:.4f} ms ({100 * share[1]:.1f}%); port/baseline "
               f"{t_new / t_old:.3f}; bitwise equal; SM clock median {mhz} "
               "MHz")
        single["patterns"][pat] = dict(baseline_ms=[turns[0], turns[3]],
                                       port_ms=[turns[1], turns[2]],
                                       sm_mhz=mhz)
    return result


def main(argv=None) -> int:
    """Build the baseline source, time both sides' entries on the same
    inputs, and print the comparison."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-n", type=int, default=24)
    ap.add_argument("--queries", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_lower_bound: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build

    _, _, smi = cs.phase_device()
    _build.load()
    per_pair = {"port": cs.report_lb_code("port", _build.build_log,
                                          _build.library_path)}
    base, base_so, base_log = build_baseline(args.baseline)
    per_pair["baseline"] = cs.report_lb_code("baseline", base_log, base_so)
    result = compare(args, torch.device("cuda", 0), base, per_pair)
    print(json.dumps({"compare": result}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
