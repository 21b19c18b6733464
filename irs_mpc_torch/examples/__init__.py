"""The example drivers of the PyTorch port: the counterparts of the JAX
package's ``examples/``, each with its builders (the JAX driver's
signatures, plus ``device``) and a ``main`` that runs the JAX driver's
budgets and writes the same curve names, and ``run_all``, the curve
runner that holds them against the committed curves:

    python -m irs_mpc_torch.examples.run_all [--check] [--cpu] [driver ...]
"""
