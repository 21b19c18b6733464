"""Run the example drivers and, with ``--check``, hold every curve they
write against the JAX package's committed one.

    python -m irs_mpc_torch.examples.run_all [--check] [--cpu] [--out DIR]
        [driver ...]

The port's counterpart of ``examples/run_all.py``: the same 15 drivers and
``quadrotor_opaque``, each at its JAX driver's budgets, on the card unless
``--cpu`` is given.  The four studies (``STUDIES``) run only when named,
each held by its checks (``STUDY_CHECKS``).  Every curve goes to
``--out`` (by default ``irs_mpc_torch/_build/curves/``); the committed
curves under ``examples/analysis/`` are only read.  With ``--check`` each
single-column curve is held to the committed ``<name>.csv`` under
``RULES`` below, no GIF is drawn, and a JSON summary goes to
``<out>/check.json``; without it the drivers' GIFs are drawn, which needs
matplotlib.  Each curve prints one line (name, initial and best against
the committed ones, the rule, the verdict and the median host ms of an
iteration after the first), each driver its wall seconds.  A driver that raises is reported and the sweep
goes on; the exit code is 1 on any failure or drift.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .. import IrsMpc, make_bicycle
from . import (bicycle, box_pivoting, box_pushing, planar_hand_second_order,
               planar_hand_spin, plate_pickup, quadrotor)
from .common import ANALYSIS_DIR, OUT_DIR, Curve, committed_curve, iterate

DRIVERS = [
    "pendulum", "bicycle", "quadrotor", "three_cart", "pendulum_nn",
    "planar_hand", "planar_hand_cem", "planar_hand_spin",
    "planar_hand_second_order", "box_pushing", "box_pushing_cem",
    "box_pushing_second_order", "box_pivoting", "plate_pickup", "carrots",
    "quadrotor_opaque",
]

# examples/run_all.py:44-46.
REL_TOL_INITIAL, REL_TOL_BEST = 1e-3, 0.12


@dataclasses.dataclass(frozen=True)
class Rule:
    """How one curve is held to its committed counterpart.

    ``initial``: the initial cost it must equal within 0.1 %; None for the
    committed curve's first value.  ``best``: "band" (the committed best
    +-12 %), "above" (at most 12 % above the committed best), "last" (at
    most 1.12 x the committed curve's last value), "below_initial" (below
    its own initial cost) or "median" (the median best over ``seeds``,
    each seed's run by ``rerun(seed, device)``, within 12 % of
    ``reference``, or at most 12 % above it if ``one_sided``).  ``source``
    says where the rule was measured and written down."""
    best: str = "band"
    initial: Optional[float] = None
    seeds: tuple = ()
    reference: Optional[float] = None
    one_sided: bool = False
    rerun: Optional[Callable] = None
    source: str = "examples/run_all.py:44-46"


def seeded_best(build, iterations, **kw):
    """A median rule's ``rerun``: the best after ``iterations`` of the
    solver that ``build(device=device, **kw)`` returns (alone or first of a
    tuple), its random stream seeded with ``seed``."""
    def best(seed, device):
        out = build(device=device, **kw)
        solver = out[0] if isinstance(out, tuple) else out
        solver = type(solver)(solver.system, dataclasses.replace(
            solver.params, seed=seed), device=device)
        iterate(solver, iterations)
        return solver.cost_best
    return best


def _bicycle(mode, hard, device):
    return IrsMpc(make_bicycle(0.1), bicycle.build_params(mode, hard),
                  device=device)


# Each example curve whose best is studied over seeds: its driver's solver
# from a seeded stream at the driver's budget (``seeded_best``), for the
# median rules below and ``irs_mpc_torch/tools/probe_curve_seeds.py``.
RERUNS = {
    "plate_pickup_zero_order": seeded_best(plate_pickup.build_solver, 10),
    "planar_hand_second_torque": seeded_best(
        planar_hand_second_order.build_solver, 15, control_mode="torque"),
    "planar_hand_second_zero_order_AB": seeded_best(
        planar_hand_second_order.build_solver, 15,
        gradient_mode="zero_order_AB"),
    **{f"planar_hand_spin_{mode}": seeded_best(
        planar_hand_spin.build_solver, 21, gradient_mode=mode)
       for mode in planar_hand_spin.MODES},
    "box_pushing_first_order": seeded_best(
        box_pushing.build_solver, 21, gradient_mode="first_order"),
    "box_pivoting_zero_order": seeded_best(
        box_pivoting.build_solver, 10, gradient_mode="zero_order_B"),
    "bicycle_easy_zero_order": seeded_best(_bicycle, 12, mode="zero_order",
                                           hard=False),
    "bicycle_easy_cem": seeded_best(bicycle.build_cem_solver, 10,
                                    hard=False),
    "quadrotor_cem": seeded_best(quadrotor.build_cem_solver, 1200),
}
SEEDS = tuple(range(8))
# Curves whose best the random stream decides in the JAX package itself:
# its own seeds on the CPU leave the committed curve's band (``python
# tests/test_torch_examples.py --jax-seeds N <curve>``; the sorted bests
# are in PERF.md §6), while the port's iterations equal the JAX package's
# on its draws wherever float32 determines them (``python
# tests/test_torch_examples.py --inject <curve> N``,
# tests/test_torch_examples_spin.py).  Each is held on the port's median
# best over the seeds against the JAX package's median over the same
# seeds, within 12 % or (one-sided) at most 12 % above it: seeds 0-7, or
# 0-23 where eight did not settle the comparison (the second-order
# zero_order_AB), or 0-1 where a seed costs ~16 min on the card and ~28 on
# the CPU (the quadrotor CEM; PERF.md §6).  (curve: the JAX package's
# median, one-sided, seeds.)
STREAM_DECIDED = {
    "planar_hand_spin_zero_order_B": (53.2725, False, SEEDS),
    "planar_hand_spin_zero_order_AB": (54.1879, False, SEEDS),
    "box_pushing_first_order": (48.6747, False, SEEDS),
    "bicycle_easy_zero_order": (708.5069, False, SEEDS),
    "box_pivoting_zero_order": (228.6181, True, SEEDS),
    "bicycle_easy_cem": (1154.7040, True, SEEDS),
    "planar_hand_second_zero_order_AB": (9.1594, True, tuple(range(24))),
    "quadrotor_cem": (10749.1328, True, (0, 1)),
}


def _rules():
    # CEM: the committed first values were recorded on a TPU at the
    # default matmul precision, so the initial cost is held to the float32
    # value both packages compute on the CPU (tests/test_torch_cem.py,
    # tests/test_torch_examples.py, tests/test_torch_examples_contact.py);
    # the best at most 1.12 x the curve's last value (chip_smoke.py,
    # CEM_CASES).
    cem = "chip_smoke.py CEM_CASES; float32 initial costs on the CPU"
    rules = {name: Rule(best="last", initial=initial, source=cem)
             for name, initial in (
                 ("pendulum_cem", 1856.1544), ("bicycle_easy_cem", 3302.0889),
                 ("bicycle_hard_cem", 13301.09), ("quadrotor_cem", 178342.11),
                 ("planar_hand_cem", 325.0136),
                 ("planar_hand_spin_cem", 247.0531),
                 ("box_pushing_cem", 134.4132),
                 ("planar_hand_second_cem", 123.7646),
                 ("planar_hand_spin_second_cem", 131.7837))}
    # Box pivoting's CEM search is basin-chaotic across program versions
    # (examples/box_pivoting.py:93-100): held below its initial cost.
    rules["box_pivoting_cem"] = Rule(best="below_initial", initial=786.3928,
                                     source=cem)
    # Box pivoting's iRS best: the JAX package's kernel chain and scan
    # chain settle in different basins (186.8 against 228.6 at 10
    # descents), so it is held from above only.
    for mode in ("exact", "first_order", "zero_order"):
        rules[f"box_pivoting_{mode}"] = Rule(
            best="above", source="chip_smoke.py:152-158")
    # The second-order paths whose finals the JAX package measured as
    # basin-chaotic under any perturbation of the estimate
    # (irs_mpc_tpu/models/contact/mbp2d.py:182-191), and box pushing's
    # (chip_smoke.py, MBP_PATHS): held from above only.
    for name in ("planar_hand_second_zero_order_B",
                 "planar_hand_spin_second_zero_order_B",
                 "box_pushing_second_order_position"):
        rules[name] = Rule(best="above",
                           source="irs_mpc_tpu/models/contact/mbp2d.py:"
                                  "182-191; chip_smoke.py:217-255")
    # Stream-decided bests: the medians over the seeds and references of
    # chip_smoke.py phases 16 and 18, then STREAM_DECIDED.
    rules["plate_pickup_zero_order"] = Rule(
        best="median", seeds=plate_pickup.GOLDEN_SEEDS,
        reference=plate_pickup.GOLDEN_BEST,
        rerun=RERUNS["plate_pickup_zero_order"],
        source="chip_smoke.py phase 16; tests/test_golden_contact.py:38")
    hand2 = planar_hand_second_order
    rules["planar_hand_second_torque"] = Rule(
        best="median", initial=812.3893, seeds=hand2.TORQUE_SEEDS,
        reference=hand2.TORQUE_JAX_MEDIAN, one_sided=True,
        rerun=RERUNS["planar_hand_second_torque"],
        source="chip_smoke.py phase 18; the JAX package's seeds 0-23")
    for name, (median, one_sided, seeds) in STREAM_DECIDED.items():
        rules[name] = Rule(
            best="median", initial=rules.get(name, DEFAULT).initial,
            seeds=seeds, reference=median, one_sided=one_sided,
            rerun=RERUNS[name],
            source=f"STREAM_DECIDED: the JAX package's seeds 0-"
                   f"{seeds[-1]} on the CPU")
    return rules


DEFAULT = Rule()
RULES = _rules()


def is_cost_curve(text: str) -> bool:
    """A single-column numeric CSV of two rows or more: a cost curve
    (examples/run_all.py:_is_cost_curve)."""
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    if len(lines) < 2:
        return False
    try:
        return all("," not in ln and float(ln) == float(ln) for ln in lines)
    except ValueError:
        return False


def check_curve(costs, committed, rule: Rule, device="cuda"):
    """Hold ``costs`` (a run's curve, seed 0's for a median rule) to the
    ``committed`` one under ``rule``.  Returns (drifts, best): what is
    out of bounds, as strings, and the best that was held."""
    costs, committed = np.asarray(costs), np.asarray(committed)
    drifts = []
    initial = committed[0] if rule.initial is None else rule.initial
    if abs(costs[0] - initial) > REL_TOL_INITIAL * abs(initial):
        drifts.append(f"initial {costs[0]:.4f} is not {initial:.4f} within "
                      f"0.1 %")
    best = float(np.min(costs))
    if rule.best == "median":
        bests = [best] + [float(rule.rerun(seed, device))
                          for seed in rule.seeds[1:]]
        best = statistics.median(bests)
        lo = 0.0 if rule.one_sided else (1 - REL_TOL_BEST) * rule.reference
        hi = (1 + REL_TOL_BEST) * rule.reference
        print("  seeds " + " ".join(f"{b:.4f}" for b in bests), flush=True)
    elif rule.best == "below_initial":
        lo, hi = 0.0, np.nextafter(costs[0], -np.inf)
    elif rule.best == "last":
        lo, hi = 0.0, (1 + REL_TOL_BEST) * committed[-1]
    else:
        ref = float(committed.min())
        lo = 0.0 if rule.best == "above" else (1 - REL_TOL_BEST) * ref
        hi = (1 + REL_TOL_BEST) * ref
    if not (np.isfinite(best) and lo <= best <= hi):
        drifts.append(f"best {best:.4f} is not in [{lo:.4f}, {hi:.4f}]")
    return drifts, best


def sweep(drivers, out_dir=OUT_DIR, device="cuda", check=False,
          analysis_dir=ANALYSIS_DIR, rules=None, studies=()) -> int:
    """Run each driver of ``drivers`` ({name: main}) and each study of
    ``studies`` and, with ``check``, hold their curves and numbers;
    returns the exit code (0, or 1 on a failure or a drift)."""
    rules = RULES if rules is None else rules
    out_dir = Path(out_dir)
    failures, drifts, summary = [], [], []
    t_total = time.perf_counter()
    for name, main in drivers.items():
        print(f"=== {name} ===", flush=True)
        t0 = time.perf_counter()
        try:
            curves = main(out_dir=out_dir, device=device, gifs=not check)
        except Exception as e:           # report it; the sweep goes on
            traceback.print_exc()
            failures.append((name, repr(e)))
            curves = []
        wall = time.perf_counter() - t0
        print(f"[{name}] wall {wall:.1f} s", flush=True)
        summary.append(dict(driver=name, seconds=wall, curves=[]))
        if not check:
            continue
        for curve in curves:
            entry = check_one(curve, analysis_dir, rules, device)
            summary[-1]["curves"].append(entry)
            if entry["drifts"]:
                drifts.append((curve.name, entry["drifts"]))
    done = run_studies(studies, out_dir, device, check)
    summary += done[0]
    failures += done[1]
    drifts += done[2]
    runs = len(drivers) + len(studies)
    print(f"total: {time.perf_counter() - t_total:.1f} s; "
          f"{runs - len(failures)}/{runs} drivers and studies OK")
    for name, err in failures:
        print(f"  FAILED {name}: {err}")
    if check:
        for name, what in drifts:
            print(f"  DRIFT {name}: " + "; ".join(what))
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "check.json").write_text(json.dumps(summary, indent=1))
        if not drifts and not failures:
            print("CHECK OK: every curve and study within its rule")
    return 1 if failures or drifts else 0


def check_one(curve: Curve, analysis_dir, rules, device):
    """Hold one curve to ``analysis_dir/<name>.csv``; print its line and
    return its summary entry."""
    path = Path(analysis_dir) / f"{curve.name}.csv"
    entry = dict(name=curve.name, initial=curve.costs[0],
                 best=float(min(curve.costs)), ms=curve.ms, drifts=[])
    if not path.exists() or not is_cost_curve(path.read_text()):
        entry["rule"] = "no committed single-column curve: not held"
        print(f"  {curve.name}: {entry['rule']}")
        return entry
    committed = np.loadtxt(path, ndmin=1)
    rule = rules.get(curve.name, DEFAULT)
    drifts, held = check_curve(curve.costs, committed, rule, device)
    entry.update(rule=rule.best, source=rule.source, held=held,
                 committed_initial=float(committed[0]),
                 committed_best=float(committed.min()),
                 committed_last=float(committed[-1]), drifts=drifts)
    ms = "n/a" if curve.ms is None else f"{curve.ms:.3f}"
    print(f"  {curve.name}: initial {curve.costs[0]:.4f} best "
          f"{entry['best']:.4f} (held {held:.4f}); committed initial "
          f"{committed[0]:.4f} best {committed.min():.4f}; rule "
          f"{rule.best} ({rule.source}); "
          + ("DRIFT: " + "; ".join(drifts) if drifts else "ok")
          + f"; {ms} ms an iteration", flush=True)
    return entry


# ---------------------------------------------------------------------------
# The studies: the JAX package's probes behind PARITY.md's findings, run by
# name (``run_all --check planar_hand_floor_probe ...``) and never in the
# default sweep, which the JAX examples/run_all.py does not run them in
# either.  Each study's ``main(out_dir, device)`` returns its numbers, and
# its checks below hold them, each with its source.
# ---------------------------------------------------------------------------

STUDIES = ("planar_hand_floor_probe", "planar_hand_second_order_estimators",
           "bundle_study", "quadrotor_cem_anneal")


def _near(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def check_floor_probe(r, device="cuda"):
    """PARITY.md:114-140 and the committed planar_hand_*_probe.csv."""
    c = r["curves"]
    cem_best = min(c["cem"])
    std_best = min(c["standard"])
    hold, polish, cem_polish = c["hold"], c["polish"], c["cem_polish"]
    out = []
    for label, curve, name in (("cem", c["cem"], "planar_hand_cem"),
                               ("standard", c["standard"],
                                "planar_hand_zero_order_B")):
        drifts, best = check_curve(curve, committed_curve(name),
                                   RULES.get(name, DEFAULT), device)
        out.append((f"{label}: held as {name} (best {best:.4f})",
                    not drifts, RULES.get(name, DEFAULT).source))
    parity = "PARITY.md:114-140; examples/analysis/planar_hand_*_probe.csv"
    out += [
        (f"cem max|du| {r['cem_du_max']:.4f} > the trust bound "
         f"{r['trust_bound']:.3f} and > the standard run's "
         f"{r['standard_du_max']:.4f} (JAX: 0.2875 against 0.076)",
         r["cem_du_max"] > r["trust_bound"]
         and r["cem_du_max"] > r["standard_du_max"], parity),
        (f"hold initial {hold[0]:.4f} = the CEM best {cem_best:.4f} within "
         f"0.1 %", _near(hold[0], cem_best, 1e-3), parity),
        (f"hold best {min(hold):.4f} = its initial {hold[0]:.4f} (committed "
         f"best = first value, 6.886)", min(hold) >= hold[0], parity),
        (f"hold last {hold[-1]:.4f} >= 1.5 x initial (committed 15.30 / "
         f"6.886 = 2.2x)", hold[-1] >= 1.5 * hold[0], parity),
        (f"polish initial {polish[0]:.4f} = the standard best "
         f"{std_best:.4f} within 0.1 %", _near(polish[0], std_best, 1e-3),
         parity),
        (f"polish best {min(polish):.4f} in 14.379 +- 12 % and <= its "
         f"initial", _near(min(polish), 14.379, 0.12)
         and min(polish) <= polish[0], parity),
        (f"cem_polish initial {cem_polish[0]:.4f} = the CEM best "
         f"{cem_best:.4f} within 0.1 %", _near(cem_polish[0], cem_best, 1e-3),
         parity),
        (f"cem_polish best {min(cem_polish):.4f} < its initial "
         f"(committed 6.886 -> 6.688)", min(cem_polish) < cem_polish[0],
         parity)]
    return out


def check_estimators(r, device="cuda"):
    """PARITY.md:188-196 and the committed planar_hand_second_estimators
    .csv: each mode's rel_err_B <= 0.02, rel_err_A within 2x (either way)
    of the committed value."""
    src = "PARITY.md:188-196; examples/analysis/planar_hand_second_" \
          "estimators.csv"
    lines = (ANALYSIS_DIR / "planar_hand_second_estimators.csv").read_text()
    committed = {row.split(",")[0]: [float(v) for v in row.split(",")[1:]]
                 for row in lines.strip().splitlines()[1:]}
    out = []
    for mode, (_, _, rel_a, rel_b) in r.items():
        ref_a = committed[mode][2]
        out.append((f"{mode} rel_err_B {rel_b:.6f} <= 0.02", rel_b <= 0.02,
                    src))
        out.append((f"{mode} rel_err_A {rel_a:.6f} within 2x of the "
                    f"committed {ref_a:.6f}",
                    0.5 * ref_a <= rel_a <= 2.0 * ref_a, src))
    return out


# The JAX study's numbers on the CPU, from ``python
# tests/test_torch_studies.py --jax-bundle``: the deterministic curves, and
# each bundled slope with its Monte-Carlo standard error over the JAX run's
# own 3000 samples (the sandwich estimate, as the contact kink makes the
# residuals heteroscedastic) and its standard deviation over the JAX
# package's seeds 0-7.  A slope is held within BUNDLE_SIGMAS of the larger
# of the two: at std 0.01 the slope rests on a few samples that touch the
# box, and the run's own estimate (6.7e-4) is half the seeds' spread
# (1.3e-3; the JAX package's seeds 0-7 range over 7.0e-4-4.9e-3).
BUNDLE_JAX = Path(__file__).with_name("bundle_study_jax.json")
# tests/test_torch_qp.py: the primal of a float32 PDIP at atol 1e-5.
BUNDLE_ATOL, BUNDLE_SIGMAS = 1e-5, 3.0


def check_bundle(r, device="cuda"):
    """The deterministic numbers against the JAX package's CPU values at
    BUNDLE_ATOL; each bundled slope within BUNDLE_SIGMAS Monte-Carlo
    standard errors of the JAX value (the larger of the run's own and the
    seeds' spread)."""
    ref = json.loads(BUNDLE_JAX.read_text())
    src = f"{BUNDLE_JAX.name} (python tests/test_torch_studies.py " \
          f"--jax-bundle)"
    out = []
    for label, got, want in (
            ("exact slope", [r["exact_slope"]], [ref["exact_slope"]]),
            ("101-point sweep", r["sweep"], ref["sweep"]),
            ("Anitescu true curve", r["Anitescu"]["true"],
             ref["true_Anitescu"]),
            ("LCP true curve", r["LCP"]["true"], ref["true_LCP"])):
        err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        out.append((f"{label}: max abs err {err:.3e} <= {BUNDLE_ATOL}",
                    err <= BUNDLE_ATOL, src))
    for std, s in r["slopes"].items():
        want = ref["slopes"][str(std)]
        se = max(ref["slope_se"][str(std)], ref["slope_seed_sd"][str(std)])
        out.append((f"bundled slope std={std}: {s:.5f} against "
                    f"{want:.5f} (standard error {se:.5f})",
                    abs(s - want) <= BUNDLE_SIGMAS * se, src))
    return out


# examples/analysis/quadrotor_cem_anneal.csv: its first value and last.
ANNEAL_INITIAL, ANNEAL_LAST = 178344.03, 9249.9


def check_anneal(r, device="cuda"):
    src = "examples/analysis/quadrotor_cem_anneal.csv; PARITY.md:73"
    bests = r["phase_bests"]
    return [
        (f"initial {r['curve'][0]:.2f} = {ANNEAL_INITIAL} within 0.1 %",
         _near(r["curve"][0], ANNEAL_INITIAL, REL_TOL_INITIAL), src),
        ("phase bests " + " -> ".join(f"{b:.1f}" for b in bests)
         + " do not rise", all(b2 <= b1 for b1, b2 in zip(bests, bests[1:])),
         src),
        (f"final best {bests[-1]:.1f} <= 1.12 x {ANNEAL_LAST}",
         bests[-1] <= (1 + REL_TOL_BEST) * ANNEAL_LAST, src)]


STUDY_CHECKS = {"planar_hand_floor_probe": check_floor_probe,
                "planar_hand_second_order_estimators": check_estimators,
                "bundle_study": check_bundle,
                "quadrotor_cem_anneal": check_anneal}


def run_studies(names, out_dir=OUT_DIR, device="cuda", check=False):
    """Run each study of ``names`` and, with ``check``, hold its numbers;
    returns (summary entries, failures, drifts)."""
    summary, failures, drifts = [], [], []
    for name in names:
        print(f"=== study {name} ===", flush=True)
        t0 = time.perf_counter()
        module = importlib.import_module(f"{__package__}.{name}")
        try:
            result = module.main(out_dir=out_dir, device=device)
        except Exception as e:           # report it; the sweep goes on
            traceback.print_exc()
            failures.append((name, repr(e)))
            continue
        wall = time.perf_counter() - t0
        print(f"[{name}] wall {wall:.1f} s", flush=True)
        entry = dict(study=name, seconds=wall, checks=[])
        if check:
            for what, ok, source in STUDY_CHECKS[name](result, device):
                print(f"  {name}: {what} ({source}): "
                      + ("ok" if ok else "DRIFT"), flush=True)
                entry["checks"].append(dict(check=what, ok=bool(ok),
                                            source=source))
                if not ok:
                    drifts.append((name, [what]))
        summary.append(entry)
    return summary, failures, drifts


def study_cli(name: str, argv=None) -> int:
    """The command line of the study ``name`` (``python -m
    irs_mpc_torch.examples.<name> [--check] [--cpu] [--out DIR]``): run
    it and, with ``--check``, hold it by its checks; with ``--check`` a
    JSON summary goes to ``<out>/check_<name>.json``.  Returns the exit
    code (1 on a failure or a drift)."""
    module = importlib.import_module(f"{__package__}.{name}")
    ap = argparse.ArgumentParser(description=module.__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="hold the study's numbers by its checks")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="where its artifacts go")
    args = ap.parse_args(argv)
    summary, failures, drifts = run_studies(
        [name], args.out, "cpu" if args.cpu else "cuda", args.check)
    if args.check:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"check_{name}.json").write_text(
            json.dumps(summary, indent=1))
        print("CHECK OK" if not (failures or drifts) else
              f"CHECK: {len(drifts)} drift(s), {len(failures)} failure(s)")
    return 1 if failures or drifts else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="hold every curve to the committed one")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="where the curves go")
    ap.add_argument("drivers", nargs="*", metavar="driver",
                    help=f"a subset of {DRIVERS}, or of the studies "
                         f"{list(STUDIES)}, which only run when named")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.drivers) - set(DRIVERS) - set(STUDIES))
    if unknown:
        ap.error(f"unknown drivers {unknown}; known: {DRIVERS} and the "
                 f"studies {list(STUDIES)}")
    studies = [s for s in STUDIES if s in args.drivers]
    names = [d for d in DRIVERS if d in args.drivers] or (
        [] if studies else DRIVERS)
    if (names and not args.check
            and importlib.util.find_spec("matplotlib") is None):
        ap.error("the drivers' GIFs need matplotlib, which is not "
                 "installed; pass --check to run without them")
    drivers = {name: importlib.import_module(f"{__package__}.{name}").main
               for name in names}
    return sweep(drivers, args.out, "cpu" if args.cpu else "cuda",
                 args.check, studies=studies)


if __name__ == "__main__":
    sys.exit(main())
