"""The experiment config and the system registry.

The port of ``irs_mpc_tpu/utils/config.py``: one dataclass, serialisable to
and from JSON or YAML, that fixes a solve, and ``make_system``, which builds
a system of the port by its registry name.  The contact families register
their model builder, so that ``contact_model`` ("anitescu" or "lcp")
overrides the model's time-stepping scheme before its ``System`` is made.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..models.bicycle import make_bicycle
from ..models.contact import systems as contact_systems
from ..models.pendulum import make_pendulum
from ..models.quadrotor import make_quadrotor
from ..models.three_cart import make_three_cart


@dataclasses.dataclass
class ExperimentConfig:
    """Everything needed to reproduce a solve (system + algorithm +
    budget)."""
    system: str = "pendulum"              # registry name
    h: float = 0.1
    T: int = 100
    gradient_mode: str = "zero_order"
    num_samples: int = 100
    std_u: float = 0.3
    std_x: float = 1e-3
    decay_power: float = 0.8
    num_iters: int = 10
    seed: int = 0
    decouple_AB: bool = False
    use_delta_u_cost: bool = False
    admm_iters: int = 30
    parallel_riccati: bool = False
    mesh_sample_shards: int = 1
    mesh_knot_shards: int = 1
    # The quasistatic systems' time-stepping scheme: "anitescu" (the
    # convex relaxation) or "lcp" (one-sided complementarity).
    contact_model: str = "anitescu"

    def to_json(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(dataclasses.asdict(self), indent=2))
        return path

    @classmethod
    def from_json(cls, path) -> "ExperimentConfig":
        return cls(**json.loads(Path(path).read_text()))

    @classmethod
    def from_yaml(cls, path) -> "ExperimentConfig":
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError("pyyaml not available; use from_json") from e
        return cls(**yaml.safe_load(Path(path).read_text()))

    def build_system(self):
        """The configured system, ``contact_model`` included."""
        return make_system(self.system, self.h,
                           contact_model=self.contact_model)


# The analytic systems, built from h.
ANALYTIC_SYSTEMS = {
    "pendulum": make_pendulum,
    "bicycle": make_bicycle,
    "quadrotor": make_quadrotor,
    "three_cart": make_three_cart,
}
# The quasistatic contact systems: their MODEL builders, from h, so that
# make_system can apply a contact_model override before the System is made.
CONTACT_SYSTEMS = {
    "planar_hand": contact_systems.make_planar_hand,
    "box_pushing": contact_systems.make_box_pushing,
    "box_pivoting": contact_systems.make_box_pivoting,
    "plate_pickup": contact_systems.make_plate_pickup,
    "carrots": lambda h: contact_systems.make_carrots(h=h),
}
SYSTEM_NAMES = sorted(ANALYTIC_SYSTEMS) + sorted(CONTACT_SYSTEMS)


def make_system(name: str, h: float, contact_model: str = "anitescu"):
    """Build a system by registry name.  ``contact_model`` selects the
    quasistatic scheme ("anitescu" | "lcp"); asking for another than the
    default on an analytic system raises ``ValueError``, an unknown name
    ``KeyError``."""
    if name in CONTACT_SYSTEMS:
        model = CONTACT_SYSTEMS[name](h)
        if contact_model != model.contact_model:
            model = dataclasses.replace(model, contact_model=contact_model)
        return model.system()
    if name not in ANALYTIC_SYSTEMS:
        raise KeyError(f"unknown system {name!r}; known: {SYSTEM_NAMES}")
    if contact_model != "anitescu":
        raise ValueError(
            f"system {name!r} has no contact-model variants; got "
            f"contact_model={contact_model!r} (only the quasistatic systems "
            f"{sorted(CONTACT_SYSTEMS)} take one)")
    return ANALYTIC_SYSTEMS[name](h)
