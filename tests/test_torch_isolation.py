"""The port imports nothing of JAX: in a fresh interpreter whose importer
refuses ``jax``, ``flax`` and ``irs_mpc_tpu`` (a ``sys.meta_path`` finder
that raises ``ImportError``), every module of ``irs_mpc_torch``
(``pkgutil.walk_packages``) and ``chip_smoke`` import.  None of them loads
matplotlib while it is imported (the card's machine has none): the
studies and ``utils/viz.py`` import it inside the functions that draw.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "irs_mpc_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
import irs_mpc_torch
names = ["irs_mpc_torch"] + [m.name for m in pkgutil.walk_packages(
    irs_mpc_torch.__path__, "irs_mpc_torch.")] + ["chip_smoke"]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def test_the_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    # The package's modules, its examples and tools among them.
    assert int(out.stdout.strip()) > 40


def test_the_port_imports_no_matplotlib():
    child = CHILD.replace("assert not leaked, leaked", (
        "assert not leaked, leaked\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "from irs_mpc_torch.examples import run_all\n"
        "assert set(run_all.STUDIES) <= set(names[i].rsplit('.', 1)[-1] "
        "for i in range(len(names)))"))
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
