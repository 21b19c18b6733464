"""The readings a cell's limits are set from: for each of a dozen seeds or
more, a short window at the cell's own size and load, then its sampled
iterations compared with the float64 reference twice: with the program's
answers (sound runs: the lower reading is their worst), and with the
reference computed in TF32 put in the program's place (the control: the
upper reading is its least).  One process reads every seed, so the set-up
is paid once.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 12 --seconds 3 \
        [--first <seed>] [--out <file.json>]

on the machine with the card; prints one JSON line a seed and the
summary, and writes them to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def study(name, seeds, seconds, device="cuda", log=sys.stdout):
    """{"seeds": [...], "lower": {...}, "upper": {...}} of cell ``name``
    over ``seeds``."""
    from benchmark import check, harness
    c = harness.cell(name)
    setup = harness.set_up(c, seeds[0], device, False)
    per_seed = []
    for seed in seeds:
        rec = setup.recorder
        rec.reset(seed)
        harness.run_window(c, setup, seed, seconds, False)
        t0 = time.perf_counter()
        sound = check.rows(c.config, c.mix, rec, device)
        t1 = time.perf_counter()
        control = check.rows(c.config, c.mix, rec, device, control=True)
        entry = dict(seed=seed, sound=sound, control=control,
                     reference_s=t1 - t0,
                     control_s=time.perf_counter() - t1)
        per_seed.append(entry)
        print(json.dumps(entry), file=log, flush=True)

    lower, upper = {}, {}
    for e in per_seed:
        for k, v in check.worst(e["sound"]).items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in check.worst(e["control"]).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    return dict(workload=name, seeds=seeds, seconds=seconds, lower=lower,
                upper=upper, per_seed=per_seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2 ** 31 + 101)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("the control study needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    result = study(args.workload, seeds, args.seconds)
    summary = {k: result[k] for k in ("workload", "seeds", "seconds",
                                      "lower", "upper")}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
