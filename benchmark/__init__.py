"""The benchmark of ``irs_mpc_torch`` on an NVIDIA H100: ``run.py`` runs one
cell of ``BENCHMARK.json`` once (see its docstring)."""
