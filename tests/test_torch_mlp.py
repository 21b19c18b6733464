"""Port parity: the learned MLP dynamics of irs_mpc_torch against the JAX
package's ``models/mlp.py`` (flax and optax), on the CPU.

* The forward pass and ``jacobian_xu`` against the flax model, with its
  weights carried by ``convert.mlp_from_flax``, at atol 1e-5.
* 50 Adam steps of ``fit_mlp`` from the carried initial weights on the JAX
  package's transitions and minibatch indices against ``optax.adam`` on
  the same: the losses and the weights at rtol 1e-3.
* The initial weights' law (LeCun normal truncated at two deviations, zero
  biases), and a tiny ``examples/pendulum_nn.py`` run on the port that
  stays finite.

    python tests/test_torch_mlp.py --jax-seeds 8

prints the JAX package's ``examples/pendulum_nn.py`` numbers (training
loss, each mode's best and its plan's cost on the true pendulum) for seeds
0-7 and their medians: the reference of ``chip_smoke.py``'s phase 21 (the
port's are ``irs_mpc_torch/tools/probe_mlp_seeds.py``).
"""
import statistics
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import irs_mpc_torch as tmpc  # noqa: E402
import irs_mpc_tpu as jmpc  # noqa: E402
from irs_mpc_tpu.models import mlp as jmlp  # noqa: E402
from irs_mpc_torch import convert  # noqa: E402
from irs_mpc_torch.models import mlp as tmlp  # noqa: E402

HIDDEN = (64, 64)


def _flax(seed=0, hidden=HIDDEN):
    model = jmlp._DynamicsMlp(hidden=hidden, dim_x=2)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros(3))


def _jax_data(N, seed=0):
    """The transitions ``train_mlp_dynamics`` draws for ``seed``."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    X = jax.random.uniform(k1, (N, 2), minval=-4.0, maxval=4.0)
    U = jax.random.uniform(k2, (N, 1), minval=-4.0, maxval=4.0)
    Y = jmpc.make_pendulum(0.05).step_batch(X, U)
    return jnp.concatenate([X, U], axis=1), Y


def test_forward_and_jacobian_match_flax():
    model, params = _flax()
    tm = convert.mlp_from_flax(params, HIDDEN, dim_x=2)
    rng = np.random.RandomState(0)
    xu = (rng.randn(16, 3) * 2).astype(np.float32)
    want = np.asarray(model.apply(params, xu))
    got = tm(torch.from_numpy(xu)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    sys_t = tmlp.mlp_system(tm, tmpc.make_pendulum(0.05))
    Jt = sys_t.jacobian_xu_batch(torch.from_numpy(xu[:, :2]),
                                 torch.from_numpy(xu[:, 2:])).numpy()
    Jj = np.asarray(jax.vmap(jax.jacfwd(
        lambda v: model.apply(params, v)))(jnp.asarray(xu)))
    assert Jt.shape == (16, 2, 3)
    np.testing.assert_allclose(Jt, Jj, atol=1e-5)


def test_fifty_adam_steps_match_optax():
    import optax
    N, batch, lr, seed = 4000, 256, 1e-3, 0
    XU, Y = _jax_data(N, seed)
    model, params = _flax(seed)
    tm = convert.mlp_from_flax(params, HIDDEN, dim_x=2)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, idx):
        def loss_fn(p):
            return jnp.mean((model.apply(p, XU[idx]) - Y[idx]) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(50):
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(rng.randint(0, N, size=batch)))
        losses.append(float(loss))
    got = tmlp.fit_mlp(tm, torch.tensor(np.asarray(XU)),
                       torch.tensor(np.asarray(Y)), 50, batch, lr, seed)
    np.testing.assert_allclose(got, losses[-1], rtol=1e-3)
    want = convert.mlp_from_flax(params, HIDDEN, dim_x=2)
    for a, b in zip(tm.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-3, atol=1e-6)


def test_initial_weights_are_truncated_lecun_normal():
    g = torch.Generator().manual_seed(0)
    m = tmlp.DynamicsMlp((256, 256), 2, 1, generator=g)
    w = m.hidden[1].weight.detach()
    std = np.sqrt(1.0 / 256)
    assert float(w.abs().max()) <= 2 * std / tmlp._TRUNC_STD + 1e-7
    assert abs(float(w.std()) - std) < 0.02 * std
    assert all(float(layer.bias.detach().abs().max()) == 0.0
               for layer in list(m.hidden) + [m.out])


def test_tiny_pendulum_nn_runs_on_the_port():
    loss, out = chip_smoke.learned_pendulum(
        "cpu", num_transitions=1000, epochs=50, T=20, num_samples=50,
        iterations=2)
    assert np.isfinite(loss) and loss > 0
    for mode, (solver, true_cost) in out.items():
        assert len(solver.cost_lst) == 3 and np.isfinite(solver.cost_lst).all()
        assert np.isfinite(true_cost)
        assert solver.system.name == "pendulum_mlp"


def jax_seed_study(seeds):
    """The JAX package's ``examples/pendulum_nn.py`` for each seed: the
    training loss, then for exact and zero_order the best cost on the
    learned model and its plan's cost on the true pendulum."""
    T = 100
    rows = []
    for seed in range(seeds):
        true_sys = jmpc.make_pendulum(0.05)
        nn_sys = jmlp.train_mlp_dynamics(true_sys, 20_000, HIDDEN,
                                         epochs=600, seed=seed)
        row = [nn_sys.final_loss]
        for mode in ("exact", "zero_order"):
            solver = jmpc.IrsMpc(nn_sys, jmpc.IrsMpcParams(
                Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]),
                R=np.diag([1.]), x0=np.zeros(2),
                xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
                u_trj_init=np.tile([0.1], (T, 1)), gradient_mode=mode,
                smoothing=jmpc.SmoothingConfig(num_samples=500, std_x=0.5,
                                               std_u=0.5)))
            solver.iterate(10, verbose=False)
            u = jnp.asarray(solver.u_trj_best)
            x = true_sys.rollout(jnp.zeros(2), u)
            row += [solver.cost_best, float(solver.eval_cost(x, u)[0])]
        rows.append(row)
        print(f"seed {seed}: " + ", ".join(
            f"{c} {v:.6g}" for c, v in zip(COLUMNS, row)), flush=True)
    print("median over seeds: " + ", ".join(
        f"{c} {statistics.median(col):.6g}"
        for c, col in zip(COLUMNS, zip(*rows))) + " (JAX, the CPU)")


COLUMNS = ("loss", "exact best", "exact true", "zero_order best",
           "zero_order true")

if __name__ == "__main__" and "--jax-seeds" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax_seed_study(int(sys.argv[sys.argv.index("--jax-seeds") + 1]))
