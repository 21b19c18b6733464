"""The system under test: ``irs_mpc_torch``, built from a configuration's
file and driven plan by plan.  This is the only module of the benchmark
that imports the program."""
from __future__ import annotations

import dataclasses

import numpy as np

import irs_mpc_torch as port
from irs_mpc_torch.models.contact import cuda_qp, cuda_rollout
from irs_mpc_torch.ops import cuda_admm, cuda_riccati
from irs_mpc_torch.solvers import irs_mpc as port_irs

from . import traffic

IrsMpc = port.IrsMpc
CrossEntropyMethod = port.CrossEntropyMethod
# The program's own launch counters, one for each hand-written kernel.
KERNELS = {"K1": cuda_riccati, "K2": cuda_qp, "K3": cuda_admm,
           "K4": cuda_rollout}


class Program:
    """The configuration's model, built once (a deployment holds it), and
    a new solver for each plan.  ``system`` may be replaced (the traced
    run wraps its rollout) before the first plan."""

    def __init__(self, config: dict, mix: dict, device):
        self.config, self.mix, self.device = config, mix, device
        model = getattr(port, config["factory"])(**config["factory_args"])
        # Run the solver counts the configuration states.
        self.model = dataclasses.replace(model, qp_iters=config["qp_iters"],
                                         qp_iters_ws=config["qp_iters_ws"])
        self.system = self.model.system()
        self.surrogate = self.model.estimation_surrogate(
            config["surrogate_qp_iters"])

    @staticmethod
    def launches() -> dict:
        """Each kernel's launches so far in this process."""
        return {k: mod.LAUNCHES for k, mod in KERNELS.items()}

    def solver(self, prob, seed: int):
        """A new planner for the problem ``prob`` (``problem.Problem``)
        with solver seed ``seed``: its constructor rolls out the initial
        guess and costs it."""
        c, mix = self.config, self.mix
        common = dict(Q=prob.Q, Qd=prob.Qd, R=prob.R, x0=prob.x0,
                      xd_trj=prob.xd_trj, u_trj_init=prob.u_init,
                      indices_u_into_x=prob.idx_u,
                      report_final_cost_with_Q=c["report_final_cost_with_Q"],
                      seed=seed)
        if mix["solver"] == "cem":
            cem = c["cem"]
            params = port.CemParams(
                n_elite=cem["n_elite"], batch_size=cem["batch_size"],
                initial_std=np.ones(c["m"]) * cem["initial_std"],
                std_floor=np.float32(cem["std_floor"]),
                momentum=cem["momentum"], noise_beta=cem["noise_beta"],
                elite_keep=cem["elite_keep"], **common)
            return CrossEntropyMethod(self.system, params, device=self.device)
        sm = c["smoothing"]
        spec = sm["decay"]
        params = port.IrsMpcParams(
            u_bounds_rel=prob.u_bounds_rel, u_bounds_abs=prob.u_bounds_abs,
            bounds_trust_region=c["bounds_trust_region"],
            unactuated_indices=prob.unactuated,
            gradient_mode=mix["gradient_mode"], decouple_AB=c["decouple_AB"],
            smoothing=port.SmoothingConfig(
                num_samples=c["num_samples"], std_u=sm["std_u"],
                std_x=sm["std_x"], decay=lambda it: traffic.decay(spec, it),
                decay_std_x=sm["decay_std_x"]),
            admm_iters=c["admm_iters"], admm_rho=c["admm_rho"],
            admm_over_relax=c["admm_over_relax"],
            line_search_alphas=tuple(c["line_search_alphas"]),
            estimation_system=self.surrogate, **common)
        return IrsMpc(self.system, params, device=self.device)


# The calls into each layer that the traced run wraps in spans, as
# (module or class, attribute, layer).
LAYER_CALLS = (
    (port_irs, "estimate_tv_matrices_fnom", "estimation"),
    (port_irs, "decouple_AB", "estimation"),
    (port_irs.admm_ops, "solve_boxed_tvlqr", "lqr"),
    (IrsMpc, "eval_cost", "cost"),
    (CrossEntropyMethod, "eval_cost", "cost"),
)
