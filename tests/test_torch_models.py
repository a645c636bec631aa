"""The VQE and QAOA models in the port against the JAX package's.

* VQE's energy and QAOA's expected cut, and their gradients by
  ``torch.autograd``, against the reference's ``jax.value_and_grad`` of
  the same functions from the same parameters, within 1e-10 at float64
  (the same plain ops in another framework; the sums run in another
  order).
* Five steps of ``torch.optim.Adam`` against ``optax.adam`` from the same
  parameters within 1e-9 (the two apply the same update formula; the
  gradients agree to 1e-10 each step).
* ``torch.autograd.gradcheck`` at float64 on the plain ops the models
  differentiate: a dense gate, a controlled one (its subspace write,
  ``out[sel] = new`` in ``ops/kernels.py``), a diagonal gate, the Pauli
  sum's expectation, the direct rotation (which no longer writes through
  ``out=``) and the QAOA cost phase.
* ``mesh=`` is accepted only as None, and the parameters land on the
  device the model names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quest_tpu.models import qaoa as ref_qaoa
from quest_tpu.models import vqe as ref_vqe
from quest_tpu_torch.models import qaoa, vqe
from quest_tpu_torch.ops import kernels, paulis

TOL = 1e-10


def _params(n, seed):
    return np.random.default_rng(seed).standard_normal(n) * 0.3


def _vqe_pair(n=5, depth=2, terms=4):
    codes, coeffs = vqe.random_hamiltonian(n, terms, seed=11)
    rc, rk = ref_vqe.random_hamiltonian(n, terms, seed=11)
    assert np.array_equal(codes, rc) and np.array_equal(coeffs, rk)
    return (ref_vqe.VQE(n, depth, codes, coeffs),
            vqe.VQE(n, depth, codes, coeffs, device="cpu"))


def _qaoa_pair(n=6, depth=2):
    edges = qaoa.random_graph(n, 2 * n, seed=1)
    assert edges == ref_qaoa.random_graph(n, 2 * n, seed=1)
    return (ref_qaoa.QAOA(n, edges, depth),
            qaoa.QAOA(n, edges, depth, device="cpu"))


def _value_and_grad(fn, p):
    t = torch.tensor(p, dtype=torch.float64, requires_grad=True)
    v = fn(t)
    v.backward()
    return float(v.detach()), t.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_vqe_energy_and_gradient_match_reference(seed):
    ref, port = _vqe_pair()
    p = _params(port.num_params, seed)
    assert port.num_params == ref.num_params
    e_ref, g_ref = jax.value_and_grad(ref.energy)(jnp.asarray(p))
    e, g = _value_and_grad(port.energy, p)
    assert abs(e - float(e_ref)) <= TOL
    np.testing.assert_allclose(g, np.asarray(g_ref), atol=TOL, rtol=0)
    amps = port.apply_ansatz(torch.tensor(p))
    np.testing.assert_allclose(amps.numpy(),
                               np.asarray(ref.apply_ansatz(jnp.asarray(p))),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_qaoa_cut_and_gradient_match_reference(seed):
    ref, port = _qaoa_pair()
    p = _params(port.num_params, seed)
    c_ref, g_ref = jax.value_and_grad(ref.expected_cut)(jnp.asarray(p))
    c, g = _value_and_grad(port.expected_cut, p)
    assert abs(c - float(c_ref)) <= TOL
    np.testing.assert_allclose(g, np.asarray(g_ref), atol=TOL, rtol=0)
    assert float(port.loss(torch.tensor(p))) == pytest.approx(-c, abs=TOL)
    np.testing.assert_allclose(port.state(torch.tensor(p)).numpy(),
                               np.asarray(ref.state(jnp.asarray(p))),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("which", ["vqe", "qaoa"])
def test_adam_steps_match_optax(which):
    ref, port = _vqe_pair() if which == "vqe" else _qaoa_pair()
    p0 = _params(port.num_params, 3)
    opt = optax.adam(5e-2)
    rp = jnp.asarray(p0)
    state = opt.init(rp)
    ref_step = jax.jit(ref.make_train_step(opt))
    t = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    step = port.make_train_step(torch.optim.Adam([t], lr=5e-2))
    for _ in range(5):
        rp, state, rv = ref_step(rp, state)
        v = step(t)
        assert abs(float(v) - float(rv)) <= 1e-9
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(rp),
                               atol=1e-9, rtol=0)


def test_training_moves_the_objective():
    _ref, port = _vqe_pair()
    g = torch.Generator().manual_seed(0)
    p = port.init_params(g, dtype=torch.float64).requires_grad_(True)
    assert p.shape == (port.num_params,) and p.device.type == "cpu"
    step = port.make_train_step(torch.optim.Adam([p], lr=5e-2))
    energies = [float(step(p)) for _ in range(8)]
    assert energies[-1] < energies[0]
    _ref, q = _qaoa_pair()
    p = q.init_params(g, dtype=torch.float64).requires_grad_(True)
    step = q.make_train_step(torch.optim.Adam([p], lr=5e-2))
    cuts = [float(step(p)) for _ in range(8)]
    assert cuts[-1] > cuts[0]


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="mesh"):
        vqe.VQE(3, 1, np.zeros((1, 3)), np.ones(1), mesh=object(),
                device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        qaoa.QAOA(3, [(0, 1, 1.0)], 1, mesh=object(), device="cpu")


def _state(n, seed):
    x = np.random.default_rng(seed).standard_normal((2, 1 << n))
    return torch.tensor(x / np.linalg.norm(x), requires_grad=True)


def _mat(k, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (2, 1 << k, 1 << k)), requires_grad=True)


GRADCHECKS = {
    "apply_matrix": lambda: (
        lambda a, m: kernels.apply_matrix(a, m, num_qubits=4,
                                          targets=(2, 0)),
        (_state(4, 0), _mat(2, 1))),
    "controlled_subspace_write": lambda: (
        lambda a, m: kernels.apply_matrix(a, m, num_qubits=4, targets=(1,),
                                          controls=(3, 0),
                                          control_states=(1, 0)),
        (_state(4, 2), _mat(1, 3))),
    "apply_diagonal": lambda: (
        lambda a, d: kernels.apply_diagonal(a, d, num_qubits=4,
                                            targets=(3,), controls=(1,)),
        (_state(4, 4), torch.tensor(np.random.default_rng(5)
                                    .standard_normal((2, 2)),
                                    requires_grad=True))),
    "expec_pauli_sum": lambda: (
        lambda a, c: paulis.calc_expec_pauli_sum_statevec(
            a, c, num_qubits=4, codes_flat=(1, 2, 0, 3, 3, 0, 1, 2),
            num_terms=2),
        (_state(4, 6), torch.tensor([0.7, -0.3], dtype=torch.float64,
                                    requires_grad=True))),
    "direct_rotation": lambda: (
        lambda a: paulis.direct_rotation_plain(
            a, paulis.pauli_term((1, 2, 0, 3), dtype=torch.float64,
                                 theta=0.4), num_qubits=4),
        (_state(4, 7),)),
    "qaoa_cost_phase": lambda: (
        lambda p: qaoa.QAOA(4, [(0, 1, 1.0), (1, 3, 0.5), (2, 3, 1.5)], 1,
                            device="cpu").expected_cut(p),
        (torch.tensor([0.3, -0.2], dtype=torch.float64,
                      requires_grad=True),)),
}


@pytest.mark.parametrize("name", sorted(GRADCHECKS))
def test_gradcheck_of_the_plain_ops(name):
    fn, args = GRADCHECKS[name]()
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7)
