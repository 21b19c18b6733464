"""irs_mpc_torch: iterative Randomized-Smoothing MPC in PyTorch and CUDA.

The PyTorch port of the JAX package beside it in this repository, which
stays the reference it is tested against.  Tensors on a CUDA device run the
hand-written kernels in ``csrc/``; tensors on the CPU run the plain PyTorch
versions of the same functions.

Importing the package sets float32 matrix products to full precision
(no TF32), the counterpart of the JAX package's
``default_matmul_precision("highest")``: the Riccati and least-squares
matrices are small but ill-conditioned.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .models.base import System  # noqa: E402
from .models.bicycle import make_bicycle  # noqa: E402
from .models.contact.mbp2d import Mbp2DModel  # noqa: E402
from .models.contact.systems import (make_box_pivoting,  # noqa: E402
                                     make_box_pushing, make_carrots,
                                     make_planar_hand, make_plate_pickup)
from .models.mlp import DynamicsMlp, train_mlp_dynamics  # noqa: E402
from .models.pendulum import make_pendulum  # noqa: E402
from .models.quadrotor import make_quadrotor  # noqa: E402
from .models.three_cart import make_three_cart  # noqa: E402
from .ops.admm import BoxBounds, solve_boxed_tvlqr  # noqa: E402
from .ops.estimators import SmoothingConfig, estimate_tv_matrices  # noqa: E402
from .ops import lqr  # noqa: E402
from .ops.lqr import riccati_backward_assoc  # noqa: E402
from .ops.solvers import SolverSpec, get_solver  # noqa: E402
from .parallel import multihost  # noqa: E402
from .parallel.sharded import (Mesh, default_mesh, make_mesh,  # noqa: E402
                               sharded_estimate_tv_matrices)
from .solvers.cem import CemParams, CrossEntropyMethod  # noqa: E402
from .solvers.irs_mpc import IrsMpc, IrsMpcParams, IterationStats  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "System", "make_pendulum", "make_bicycle", "make_quadrotor",
    "make_three_cart", "make_planar_hand", "make_box_pushing",
    "make_box_pivoting", "make_plate_pickup", "make_carrots",
    "Mbp2DModel", "DynamicsMlp", "train_mlp_dynamics", "SmoothingConfig",
    "estimate_tv_matrices", "lqr", "riccati_backward_assoc", "BoxBounds",
    "solve_boxed_tvlqr", "SolverSpec", "get_solver", "Mesh", "make_mesh",
    "default_mesh", "sharded_estimate_tv_matrices", "multihost",
    "IrsMpc", "IrsMpcParams", "IterationStats", "CemParams",
    "CrossEntropyMethod",
]


def contact_systems():
    """The contact-system factory module (``make_planar_hand`` and the
    others), as the JAX package's ``contact_systems()`` returns its own."""
    from .models.contact import systems
    return systems
