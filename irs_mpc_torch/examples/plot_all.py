"""The aggregate plot of the cost curves the port's drivers wrote.

The port of ``examples/plot_all.py``: every ``*.csv`` in the port's curve
directory (``--out``, by default ``irs_mpc_torch/_build/curves/``) in a
grid of log-scale convergence plots, ``all_curves.png`` in that same
directory.  Files that are not a single-column curve (a study's table)
get a blank panel.  Where matplotlib is not installed (the card's
machine) it says so and draws nothing.

    python -m irs_mpc_torch.examples.plot_all [--out DIR]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import OUT_DIR, out_path


def main(out_dir=OUT_DIR):
    """Draw the grid; returns its path, or None when nothing was drawn."""
    csvs = sorted(Path(out_dir).glob("*.csv"))
    if not csvs:
        print(f"no curves in {out_dir}: run the example drivers first")
        return None
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no plot of the {len(csvs)} "
              f"curves in {out_dir}")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ncols = 3
    nrows = (len(csvs) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 2.8 * nrows))
    axes = np.atleast_2d(axes)
    for i, path in enumerate(csvs):
        ax = axes[i // ncols][i % ncols]
        try:
            ys = np.loadtxt(path, delimiter=",")
        except ValueError:
            ax.set_title(f"{path.stem} (non-curve)", fontsize=9)
            ax.axis("off")
            continue
        ax.plot(ys)
        ax.set_title(path.stem, fontsize=9)
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
    for j in range(len(csvs), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = out_path(out_dir, "all_curves.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"saved {out} ({len(csvs)} curves)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    main(ap.parse_args().out)
