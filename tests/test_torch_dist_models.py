"""The VQE and QAOA models on a mesh (M15c) against the JAX package's.

``VQE(mesh=env.mesh)`` and ``QAOA(mesh=env.mesh)`` on the port's
in-process mesh (``tq.createQuESTEnv(devices=["cpu"] * R)``, R = 2 and
4) keep the state as R differentiable shard tensors (models/vqe.py):

* the energy (expected cut) and its ``torch.autograd`` gradient within
  1e-10 of the reference's ``jax.value_and_grad`` with its own mesh
  (``qt.createQuESTEnv(num_devices=R).mesh``, the state's sharding
  constrained as quest_tpu/models/vqe.py:75-78 does), at float64;
* the gradient within 1e-10 of the port's ``mesh=None`` model, and
  within 1e-3 of central differences;
* the state, gathered, within 1e-10 of the one-register state;
* a few Adam steps on the mesh lower the VQE energy (raise the cut).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as qt
from quest_tpu.models import qaoa as ref_qaoa
from quest_tpu.models import vqe as ref_vqe
import quest_tpu_torch as tq
from quest_tpu_torch.models import qaoa, vqe
from quest_tpu_torch.parallel import sharded as SH
from quest_tpu_torch.parallel.mesh import ShardedAmps

TOL = 1e-10
MESHES = (2, 4)
N_VQE, N_QAOA = 6, 8


def _meshes(R):
    if qt.createQuESTEnv().num_devices < 8:
        pytest.skip("needs the suite's 8-device CPU mesh")
    return (qt.createQuESTEnv(num_devices=R).mesh,
            tq.createQuESTEnv(devices=["cpu"] * R).mesh)


def _params(n, seed):
    return np.random.default_rng(seed).standard_normal(n) * 0.3


def _models(kind, R):
    rmesh, pmesh = _meshes(R)
    if kind == "vqe":
        codes, coeffs = vqe.random_hamiltonian(N_VQE, 5, seed=11)
        return (ref_vqe.VQE(N_VQE, 2, codes, coeffs, mesh=rmesh),
                vqe.VQE(N_VQE, 2, codes, coeffs, mesh=pmesh),
                vqe.VQE(N_VQE, 2, codes, coeffs, device="cpu"))
    edges = qaoa.random_graph(N_QAOA, 2 * N_QAOA, seed=1)
    return (ref_qaoa.QAOA(N_QAOA, edges, 2, mesh=rmesh),
            qaoa.QAOA(N_QAOA, edges, 2, mesh=pmesh),
            qaoa.QAOA(N_QAOA, edges, 2, device="cpu"))


def _objective(kind, model):
    return model.energy if kind == "vqe" else model.expected_cut


def _value_and_grad(fn, p):
    t = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    v = fn(t)
    v.backward()
    return float(v.detach()), t.grad.numpy()


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("kind", ["vqe", "qaoa"])
def test_objective_and_gradient_on_a_mesh(kind, R):
    ref, port, one = _models(kind, R)
    assert port.device == torch.device("cpu")
    p = _params(port.num_params, 3)
    v_ref, g_ref = jax.value_and_grad(_objective(kind, ref))(jnp.asarray(p))
    v, g = _value_and_grad(_objective(kind, port), p)
    assert abs(v - float(v_ref)) <= TOL
    np.testing.assert_allclose(g, np.asarray(g_ref), atol=TOL, rtol=0)
    v1, g1 = _value_and_grad(_objective(kind, one), p)
    assert abs(v - v1) <= TOL
    np.testing.assert_allclose(g, g1, atol=TOL, rtol=0)
    # central differences of the mesh model's own objective
    fn = _objective(kind, port)
    h = 1e-5
    fd = np.empty_like(p)
    for i in range(p.size):
        e = np.zeros_like(p)
        e[i] = h
        fd[i] = (float(fn(torch.tensor(p + e)))
                 - float(fn(torch.tensor(p - e)))) / (2 * h)
    np.testing.assert_allclose(g, fd, atol=1e-3, rtol=0)


@pytest.mark.parametrize("R", MESHES)
@pytest.mark.parametrize("kind", ["vqe", "qaoa"])
def test_state_on_a_mesh_is_the_one_register_state(kind, R):
    _ref, port, one = _models(kind, R)
    p = torch.tensor(_params(port.num_params, 4))
    make = (lambda m: m.apply_ansatz(p)) if kind == "vqe" \
        else (lambda m: m.state(p))
    sharded = make(port)
    assert isinstance(sharded, ShardedAmps)
    assert len(sharded.shards) == R
    np.testing.assert_allclose(SH.gather_host(sharded),
                               make(one).detach().numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("R", MESHES)
def test_training_on_a_mesh_moves_the_objective(R):
    _ref, port, _one = _models("vqe", R)
    g = torch.Generator().manual_seed(0)
    p = port.init_params(g, dtype=torch.float64).requires_grad_(True)
    step = port.make_train_step(torch.optim.Adam([p], lr=5e-2))
    energies = [float(step(p)) for _ in range(4)]
    assert energies[-1] < energies[0]
    _ref, q, _one = _models("qaoa", R)
    p = q.init_params(g, dtype=torch.float64).requires_grad_(True)
    step = q.make_train_step(torch.optim.Adam([p], lr=5e-2))
    cuts = [float(step(p)) for _ in range(4)]
    assert cuts[-1] > cuts[0]
