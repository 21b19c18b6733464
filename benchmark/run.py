"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up (import, the kernels' build on a checkout's first run, the
model, one warm plan) is timed as ``setup_s``; then plans run back to back
for ``--seconds``; then a sample of the window's iterations is recomputed
by the plain reference.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones.  The last line of standard
output is the result's JSON object; the last lines of standard error are
the numbers compared, each beside its limit.  Without the card, or with
the JAX package or JAX loaded once the window has closed, it exits
non-zero and prints no result.
"""
import time

START = time.perf_counter()     # set-up counts from here: imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / "_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "irs_mpc_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every build and kernel cache at a fixed place inside the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # The benchmark is a package of the checkout, never a directory of
    # top-level modules.
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         started=START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
