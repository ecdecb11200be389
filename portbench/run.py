"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared against the reference, each
beside its limit, are the last lines of standard error. Exits non-zero, with
no result, where there is no card or the program cannot be imported.
"""

import time

T0 = time.perf_counter()  # set-up counts from the start of the process

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"  # fixed, inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# The checkout and its sources, in place of this script's own directory.
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T0))
