"""The port's whole-circuit functions and the last module-level helpers
against the JAX package's, at float64.

* ``models/circuits.py``: ``ghz_layer``, ``build_random_circuit`` (the
  same NumPy unitaries; both ``use_scan`` values), ``qft_circuit``
  (layered at 6 qubits, ``circuit.fused_qft`` at 14), ``grover_circuit``
  and ``bernstein_vazirani_circuit``, within 1e-10.
* ``ops/kernels.swap_qubit_amps`` bit for bit (an exact transpose),
  ``ops/density.init_pure_state_density``, ``ops/cplx.cmul_s`` and
  ``scale``; ``initPureState`` on a density register through it.
* The five validators copied from the reference's ``validation.py``: the
  same inputs raise in both packages with the same message, and the same
  inputs pass.
* ``optimizer.clear_cache`` empties the memoized rewrites as the
  reference's does; ``env.report_quest_env`` is ``reportQuESTEnv``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as rq
import quest_tpu_torch as tq
from quest_tpu import optimizer as ref_opt
from quest_tpu import validation as ref_val
from quest_tpu.models import circuits as ref_circ
from quest_tpu.ops import cplx as ref_cplx
from quest_tpu.ops import density as ref_density
from quest_tpu.ops import kernels as ref_kernels
from quest_tpu_torch import env as tenv
from quest_tpu_torch import optimizer as opt
from quest_tpu_torch import validation as val
from quest_tpu_torch.models import circuits
from quest_tpu_torch.ops import cplx, density, kernels

TOL = 1e-10


def _state(n, seed):
    a = np.random.default_rng(seed).standard_normal((2, 1 << n))
    return a / np.sqrt((a ** 2).sum())


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.reshape(np.shape(want)),
                               np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("n", [3, 6])
def test_ghz_layer(n):
    a = _state(n, 1)
    _close(circuits.ghz_layer(torch.from_numpy(a), n),
           ref_circ.ghz_layer(jnp.asarray(a), n))


@pytest.mark.parametrize("use_scan", [True, False])
def test_build_random_circuit(use_scan):
    n, depth = 5, 4
    ref_fn, ref_us = ref_circ.build_random_circuit(n, depth, seed=3,
                                                   use_scan=use_scan)
    fn, us = circuits.build_random_circuit(n, depth, seed=3,
                                           use_scan=use_scan, device="cpu")
    assert us.dtype == torch.float32 and us.device.type == "cpu"
    np.testing.assert_array_equal(us.numpy(), np.asarray(ref_us))
    a = _state(n, 2)
    _close(fn(torch.from_numpy(a), us), ref_fn(jnp.asarray(a), ref_us))


@pytest.mark.parametrize("n,layered", [(6, True), (6, False), (14, False)])
def test_qft_circuit(n, layered):
    a = _state(n, 4)
    want = ref_circ.qft_circuit(jnp.asarray(a), n, layered=layered)
    _close(circuits.qft_circuit(torch.from_numpy(a.copy()), n,
                                layered=layered), want)


@pytest.mark.parametrize("n,marked", [(3, 5), (6, 17)])
def test_grover_circuit(n, marked):
    got = circuits.grover_circuit(n, marked, dtype=torch.float64,
                                  device="cpu")
    _close(got, ref_circ.grover_circuit(n, marked, dtype=jnp.float64))
    assert got.dtype == torch.float64 and got.device.type == "cpu"


@pytest.mark.parametrize("n,secret", [(4, 9), (7, 77)])
def test_bernstein_vazirani_circuit(n, secret):
    got = circuits.bernstein_vazirani_circuit(n, secret, dtype=torch.float64,
                                              device="cpu")
    _close(got, ref_circ.bernstein_vazirani_circuit(n, secret,
                                                    dtype=jnp.float64))
    probs = (got ** 2).sum(0)
    assert float(probs[secret]) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("qb1,qb2", [(0, 5), (4, 1), (2, 2), (0, 1)])
def test_swap_qubit_amps_bit_for_bit(qb1, qb2):
    n = 6
    a = _state(n, 5)
    got = kernels.swap_qubit_amps(torch.from_numpy(a), num_qubits=n,
                                  qb1=qb1, qb2=qb2)
    want = ref_kernels.swap_qubit_amps(jnp.asarray(a), num_qubits=n,
                                       qb1=qb1, qb2=qb2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_pure_state_density():
    n = 4
    psi = _state(n, 6)
    _close(density.init_pure_state_density(torch.from_numpy(psi),
                                           num_qubits=n),
           ref_density.init_pure_state_density(jnp.asarray(psi),
                                               num_qubits=n), 1e-15)
    with pytest.raises(ValueError, match="not one of 3 qubits"):
        density.init_pure_state_density(torch.from_numpy(psi), num_qubits=3)


def test_init_pure_state_goes_through_init_pure_state_density():
    n = 3
    env = tq.createQuESTEnv(device="cpu")
    psi = tq.createQureg(n, env)
    tq.initDebugState(psi)
    rho = tq.createDensityQureg(n, env)
    tq.initPureState(rho, psi)
    want = density.init_pure_state_density(psi.amps, num_qubits=n)
    assert torch.equal(rho.amps.reshape(want.shape), want.to(rho.amps.dtype))


def test_cmul_s_and_scale():
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((2, 2, 3, 4))
    _close(cplx.cmul_s(torch.from_numpy(a), torch.from_numpy(b)),
           ref_cplx.cmul_s(jnp.asarray(a), jnp.asarray(b)), 1e-15)
    _close(cplx.scale(torch.from_numpy(a), 0.25),
           ref_cplx.scale(jnp.asarray(a), 0.25), 0.0)


def _outcome(fn, *args):
    """The message a validator raised with, or None."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001
        assert type(e).__name__ == "QuESTError", repr(e)
        return str(e)
    return None


class _Mat:
    def __init__(self, real):
        self.real = real


@pytest.mark.parametrize("name,args", [
    ("validate_num_ranks", (1, "createQuESTEnv")),
    ("validate_num_ranks", (8, "createQuESTEnv")),
    ("validate_num_ranks", (6, "createQuESTEnv")),
    ("validate_num_ranks", (0, "f")),
    ("validate_num_qubits_in_matrix", (3, "createComplexMatrixN")),
    ("validate_num_qubits_in_matrix", (0, "createComplexMatrixN")),
    ("validate_num_qubits_in_matrix", (-2, "createComplexMatrixN")),
    ("validate_matrix_init", (None, "multiQubitUnitary")),
    ("validate_matrix_init", (_Mat(None), "multiQubitUnitary")),
    ("validate_matrix_init", (_Mat([[1.0]]), "multiQubitUnitary")),
    ("validate_matrix_init", (np.eye(2), "multiQubitUnitary")),
    ("validate_measurement_prob", (0.5, "collapseToOutcome")),
    ("validate_measurement_prob", (0.0, "collapseToOutcome")),
    ("validate_measurement_prob", (1e-20, "collapseToOutcome")),
    ("validate_norm_probs", (0.25, 0.75, "mixPauli")),
    ("validate_norm_probs", (0.3, 0.3, "mixPauli")),
    ("validate_norm_probs", (-0.1, 1.1, "mixPauli")),
    ("validate_norm_probs", (0.5, 1.5, "mixPauli")),
])
def test_validators_raise_as_the_reference(name, args):
    want = _outcome(getattr(ref_val, name), *args)
    got = _outcome(getattr(val, name), *args)
    assert got == want


def test_validators_raise_somewhere():
    """The cases above are not all passes: each validator raises."""
    assert "power-of-2" in _outcome(val.validate_num_ranks, 6, "f")
    assert "Must create >0" in _outcome(val.validate_num_qubits_in_matrix,
                                        0, "f")
    assert "not successfully created" in _outcome(val.validate_matrix_init,
                                                  None, "f")
    assert "zero probability" in _outcome(val.validate_measurement_prob,
                                          0.0, "f")
    assert "sum to ~1" in _outcome(val.validate_norm_probs, 0.3, 0.3, "f")


def test_collapse_to_outcome_refuses_zero_probability_as_the_reference():
    for pkg, env in ((tq, tq.createQuESTEnv(device="cpu")),
                     (rq, rq.createQuESTEnv(num_devices=1))):
        q = pkg.createQureg(2, env)
        pkg.initZeroState(q)
        with pytest.raises(pkg.QuESTError) as e:
            pkg.collapseToOutcome(q, 0, 1)
        assert "collapseToOutcome: Can't collapse to state with zero " \
               "probability." in str(e.value)


def _fill_optimizer_cache(pkg_opt, C, rng_seed):
    rng = np.random.default_rng(rng_seed)
    h = np.stack([np.eye(2), np.zeros((2, 2))])
    gates = [C.Gate((0,), h), C.Gate((0,), h),
             C.Gate((1,), np.stack([rng.standard_normal((2, 2)),
                                    np.zeros((2, 2))]))]
    pkg_opt.optimize_items(gates, nloc=3, n=3)


def test_clear_cache_empties_the_memoized_rewrites():
    from quest_tpu import circuit as ref_C
    from quest_tpu_torch import circuit as C

    # the overrides as they were (None: QT_OPTIMIZER decides)
    prev = opt._OVERRIDE[0], ref_opt._OVERRIDE[0]
    try:
        opt.set_circuit_optimizer("on")
        ref_opt.set_circuit_optimizer("on")
        # other tests of the process leave their rewrites memoized
        opt._cache.clear()
        ref_opt._cache.clear()
        _fill_optimizer_cache(opt, C, 1)
        _fill_optimizer_cache(ref_opt, ref_C, 1)
        assert len(opt._cache) == len(ref_opt._cache) > 0
        opt.clear_cache()
        ref_opt.clear_cache()
        assert len(opt._cache) == len(ref_opt._cache) == 0
    finally:
        opt._OVERRIDE[0], ref_opt._OVERRIDE[0] = prev
    assert opt.setCircuitOptimizer is opt.set_circuit_optimizer
    assert opt.getCircuitOptimizer is opt.get_circuit_optimizer
    assert tq.setCircuitOptimizer is opt.set_circuit_optimizer


def test_report_quest_env_is_report_quest_env(capsys):
    assert tq.reportQuESTEnv is tenv.report_quest_env
    env = tq.createQuESTEnv(device="cpu")
    tenv.report_quest_env(env)
    assert capsys.readouterr().out.startswith(
        "EnvType=quest_tpu_torch Backend=cpu")
