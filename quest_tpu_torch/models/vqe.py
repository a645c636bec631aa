"""VQE: the variational quantum eigensolver as a training workload.

The port of the JAX package's ``models/vqe.py``: a hardware-efficient
ansatz (Ry and Rz layers with a CZ entangler chain) minimising
<psi(theta)| H |psi(theta)> for a PauliHamil H (calcExpecPauliHamil,
QuEST.h:4285).  The ansatz and the energy are the plain PyTorch ops of
``ops/kernels.py`` and ``ops/paulis.py`` (the reference differentiates
plain XLA ops, never a Pallas kernel), so ``torch.autograd`` gives the
gradient and a ``torch.optim`` optimizer (Adam in place of
``optax.adam``) the update.  The state lives on the parameters' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import precision
from ..ops import cplx, kernels, paulis


def _ry_soa(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    re = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return torch.stack([re, torch.zeros_like(re)])


def _rz_diag_soa(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return torch.stack([torch.stack([c, c]), torch.stack([-s, s])])


def _model_device(device, mesh):
    if mesh is not None:
        from ..parallel.mesh import PENDING_SLICE

        raise NotImplementedError(
            "a model on a mesh (multi-GPU sharding) arrives with slice "
            f"{PENDING_SLICE}; pass mesh=None")
    return torch.device("cuda" if device is None else device)


class VQE:
    """Hardware-efficient ansatz (Ry + Rz layers with a CZ entangler
    chain) minimising <psi(theta)| H |psi(theta)> for a PauliHamil H.
    ``device`` (default the CUDA card) is where ``init_params`` puts the
    parameters; the state follows the parameters."""

    def __init__(self, num_qubits: int, depth: int, hamil_codes: np.ndarray,
                 hamil_coeffs: np.ndarray, mesh=None, device=None):
        self.num_qubits = int(num_qubits)
        self.depth = int(depth)
        self.codes_flat = tuple(int(c)
                                for c in np.asarray(hamil_codes).ravel())
        self.num_terms = int(np.asarray(hamil_coeffs).size)
        self.coeffs = np.asarray(hamil_coeffs, dtype=np.float64)
        self.mesh = mesh
        self.device = _model_device(device, mesh)

    @property
    def num_params(self) -> int:
        return 2 * self.num_qubits * self.depth

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=None) -> torch.Tensor:
        """0.1 times standard normal parameters from ``generator``, of
        the working precision's type unless ``dtype`` is given."""
        dtype = dtype or precision.real_dtype()
        p = torch.randn(self.num_params, generator=generator,
                        dtype=torch.float64)
        return (0.1 * p).to(dtype=dtype, device=self.device)

    def apply_ansatz(self, params):
        n = self.num_qubits
        amps = kernels.init_zero_state(1 << n, params.dtype, params.device)
        p = params.reshape(self.depth, 2, n)
        cz = torch.as_tensor(
            cplx.soa(np.diag([1, 1, 1, -1]).astype(np.complex128)),
            dtype=params.dtype, device=params.device)
        for layer in range(self.depth):
            for q in range(n):
                amps = kernels.apply_matrix(
                    amps, _ry_soa(p[layer, 0, q]), num_qubits=n,
                    targets=(q,))
                amps = kernels.apply_diagonal(
                    amps, _rz_diag_soa(p[layer, 1, q]), num_qubits=n,
                    targets=(q,))
            for q in range(n - 1):
                amps = kernels.apply_matrix(amps, cz, num_qubits=n,
                                            targets=(q, q + 1))
        return amps

    def energy(self, params):
        amps = self.apply_ansatz(params)
        return paulis.calc_expec_pauli_sum_statevec(
            amps, self.coeffs, num_qubits=self.num_qubits,
            codes_flat=self.codes_flat, num_terms=self.num_terms)

    def make_train_step(self, optimizer: torch.optim.Optimizer):
        """One (energy, gradient, update) step: ``step(params)`` on the
        leaf tensor ``optimizer`` holds, updated in place; returns the
        energy before the update."""

        def step(params):
            optimizer.zero_grad()
            e = self.energy(params)
            e.backward()
            optimizer.step()
            return e.detach()

        return step


def random_hamiltonian(num_qubits: int, num_terms: int, seed: int = 0):
    """Random PauliHamil (codes, coeffs) for benchmarks and tests."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(num_terms, num_qubits))
    coeffs = rng.standard_normal(num_terms)
    return codes, coeffs
