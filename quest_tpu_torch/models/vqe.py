"""VQE: the variational quantum eigensolver as a training workload.

The port of the JAX package's ``models/vqe.py``: a hardware-efficient
ansatz (Ry and Rz layers with a CZ entangler chain) minimising
<psi(theta)| H |psi(theta)> for a PauliHamil H (calcExpecPauliHamil,
QuEST.h:4285).  The ansatz and the energy are the plain PyTorch ops of
``ops/kernels.py`` and ``ops/paulis.py`` (the reference differentiates
plain XLA ops, never a Pallas kernel), so ``torch.autograd`` gives the
gradient and a ``torch.optim`` optimizer (Adam in place of
``optax.adam``) the update.  The state lives on the parameters' device.

With ``mesh=env.mesh`` (an env of R shards) the state is R shard tensors
of ``(2, 2^nloc)``, the reference's state sharded over its mesh
(quest_tpu/models/vqe.py:75-78, where GSPMD places it): a gate on a
local qubit runs the one-register op on each shard, a gate on a mesh
bit exchanges each shard with its partner out of place
(``Mesh.exchange``: ``.to()`` on the in-process mesh, an autograd
function whose backward is the reverse exchange under
torch.distributed), and the energy sums per-shard partials with a
differentiable mesh sum (``Mesh.sum_grad``).  The parameters enter
through ``Mesh.replicate``, which sums their gradient over the ranks.
The in-place exchange layer (parallel/dist.py) is never used here: its
writes would break autograd's version counters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import precision
from ..ops import cplx, kernels, paulis
from ..parallel.mesh import ShardedAmps


def _ry_soa(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    re = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return torch.stack([re, torch.zeros_like(re)])


def _rz_diag_soa(theta):
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return torch.stack([torch.stack([c, c]), torch.stack([-s, s])])


def _model_device(device, mesh):
    """The parameters' device: the mesh's (its first local shard's) on a
    mesh, else ``device`` (default the CUDA card)."""
    if mesh is not None:
        from ..parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh= takes the port's Mesh (an env's mesh, "
                f"createQuESTEnv(...).mesh), not {type(mesh).__name__}")
        return mesh.device_of(mesh.local[0])
    return torch.device("cuda" if device is None else device)


# ---------------------------------------------------------------------------
# A differentiable state on a mesh: R shard tensors, out-of-place gates
# ---------------------------------------------------------------------------


def _mesh_nloc(mesh, n: int) -> int:
    r = mesh.axis_size.bit_length() - 1
    if n <= r:
        raise ValueError(f"a model of {n} qubits cannot span {1 << r} "
                         "shards")
    return n - r


def _mesh_uniform(mesh, nloc: int, value: float, dtype):
    """Every local shard of the state whose amplitudes are all ``value``
    (|0...0> is ``value`` 0 with one 1 in shard 0: ``_mesh_zero``)."""
    out = []
    for s in mesh.local:
        t = torch.zeros((2, 1 << nloc), dtype=dtype,
                        device=mesh.device_of(s))
        t[0] = value
        out.append(t)
    return out


def _mesh_zero(mesh, nloc: int, dtype):
    out = _mesh_uniform(mesh, nloc, 0.0, dtype)
    for k, s in enumerate(mesh.local):
        if s == 0:
            out[k][0, 0] = 1.0
    return out


def _partners(mesh, xs, mask: int):
    """Per local shard s, shard s ^ mask's tensor (differentiable)."""
    if not mask:
        return list(xs)
    return mesh.exchange(xs, [(i, i ^ mask) for i in range(mesh.axis_size)])


def _cmul(x, re, im):
    """(re + i im) x on a (2, ...) SoA tensor, re and im 0-d tensors."""
    return torch.stack([re * x[0] - im * x[1], re * x[1] + im * x[0]])


def mesh_gate_1q(mesh, xs, m, q: int, nloc: int):
    """A one-qubit SoA (2, 2, 2) gate on qubit ``q`` of the sharded state
    ``xs``: the one-register op on each shard for a local qubit; on a
    mesh bit b each shard combines m[b, b] own + m[b, 1 - b] partner."""
    if q < nloc:
        return [kernels.apply_matrix(x, m, num_qubits=nloc, targets=(q,))
                for x in xs]
    bit = q - nloc
    recv = _partners(mesh, xs, 1 << bit)
    out = []
    for k, s in enumerate(mesh.local):
        b = (s >> bit) & 1
        mk = m.to(xs[k].device)
        out.append(_cmul(xs[k], mk[0, b, b], mk[1, b, b])
                   + _cmul(recv[k], mk[0, b, 1 - b], mk[1, b, 1 - b]))
    return out


def mesh_diag_1q(mesh, xs, d, q: int, nloc: int):
    """A one-qubit SoA (2, 2) diagonal on qubit ``q``: on a mesh bit each
    shard takes its entry as a scalar (no data moves)."""
    if q < nloc:
        return [kernels.apply_diagonal(x, d, num_qubits=nloc, targets=(q,))
                for x in xs]
    bit = q - nloc
    out = []
    for k, s in enumerate(mesh.local):
        b = (s >> bit) & 1
        dk = d.to(xs[k].device)
        out.append(_cmul(xs[k], dk[0, b], dk[1, b]))
    return out


def mesh_cz(mesh, xs, q: int, cz, nloc: int):
    """CZ on (q, q + 1): the one-register product on two local qubits; a
    Z on q in the shards whose mesh bit q + 1 is set; a sign in the
    shards where both are set mesh bits."""
    if q + 1 < nloc:
        return [kernels.apply_matrix(x, cz, num_qubits=nloc,
                                     targets=(q, q + 1)) for x in xs]
    z = np.stack([np.array([1.0, -1.0]), np.zeros(2)])
    out = []
    for k, s in enumerate(mesh.local):
        hi = (s >> (q + 1 - nloc)) & 1
        if not hi:
            out.append(xs[k])
        elif q < nloc:
            out.append(kernels.apply_diagonal(xs[k], z, num_qubits=nloc,
                                              targets=(q,)))
        else:
            out.append(-xs[k] if (s >> (q - nloc)) & 1 else xs[k])
    return out


def mesh_expec_pauli_sum(mesh, xs, coeffs, codes_flat, n: int, nloc: int):
    """sum_t c_t Re <psi| P_t |psi> of the sharded state: per term the
    partner shard across the term's mesh flips (differentiable) and the
    local signed gather (ops/paulis._signed_partner), per-shard partials,
    one differentiable sum over the mesh."""
    from ..parallel import composites as COMP

    hi, lo = paulis._split(nloc)
    dt = xs[0].dtype
    parts = [torch.zeros((), dtype=dt, device=x.device) for x in xs]
    for t, c in enumerate(coeffs):
        term = paulis.pauli_term(codes_flat[t * n:(t + 1) * n], dtype=dt)
        recv = _partners(mesh, xs, term.fm >> nloc)
        for k, s in enumerate(mesh.local):
            pr, pi = paulis._signed_partner(
                recv[k], COMP._local_term(term, s, nloc), nloc)
            x = xs[k].reshape(2, 1 << hi, 1 << lo)
            parts[k] = parts[k] + float(c) * torch.sum(x[0] * pr
                                                       + x[1] * pi)
    return mesh.sum_grad(parts)


class VQE:
    """Hardware-efficient ansatz (Ry + Rz layers with a CZ entangler
    chain) minimising <psi(theta)| H |psi(theta)> for a PauliHamil H.
    ``device`` (default the CUDA card) is where ``init_params`` puts the
    parameters; the state follows the parameters.  ``mesh`` (an env's
    ``mesh``) shards the state over the mesh's devices, and the
    parameters live on its first local shard's device."""

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
        """The ansatz state: a (2, 2^n) tensor, or on a mesh a
        ShardedAmps of differentiable shard tensors."""
        n = self.num_qubits
        p = params.reshape(self.depth, 2, n)
        cz = torch.as_tensor(
            cplx.soa(np.diag([1, 1, 1, -1]).astype(np.complex128)),
            dtype=params.dtype, device=params.device)
        if self.mesh is not None:
            return self._apply_ansatz_mesh(self.mesh.replicate(p), cz)
        amps = kernels.init_zero_state(1 << n, params.dtype, params.device)
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

    def _apply_ansatz_mesh(self, p, cz):
        mesh, n = self.mesh, self.num_qubits
        nloc = _mesh_nloc(mesh, n)
        xs = _mesh_zero(mesh, nloc, p.dtype)
        for layer in range(self.depth):
            for q in range(n):
                xs = mesh_gate_1q(mesh, xs, _ry_soa(p[layer, 0, q]), q, nloc)
                xs = mesh_diag_1q(mesh, xs, _rz_diag_soa(p[layer, 1, q]), q,
                                  nloc)
            for q in range(n - 1):
                xs = mesh_cz(mesh, xs, q, cz, nloc)
        return ShardedAmps(mesh, xs)

    def energy(self, params):
        amps = self.apply_ansatz(params)
        if self.mesh is not None:
            n = self.num_qubits
            return mesh_expec_pauli_sum(self.mesh, amps.shards, self.coeffs,
                                        self.codes_flat, n,
                                        _mesh_nloc(self.mesh, n))
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
