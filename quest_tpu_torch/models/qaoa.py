"""QAOA for MaxCut: the second training workload on the simulator.

The port of the JAX package's ``models/qaoa.py``: p alternating layers of
the diagonal cost phase e^{-i gamma C} and RX(2 beta) mixers on |+>^n,
maximising the expected cut <psi| C |psi>.  The cost is built on the
device from bit views (``kernels.bit_2d``), the layers are plain PyTorch
ops, and ``torch.autograd`` gives the gradient (the reference
differentiates plain XLA ops, never a Pallas kernel).  The state lives on
the parameters' device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import precision
from ..ops import kernels
from .vqe import _model_device


class QAOA:
    """p-layer QAOA minimising the MaxCut loss -C(z), C(z) = sum_e w_e
    [z_i != z_j], over ``edges`` = [(i, j, w), ...].  ``device`` (default
    the CUDA card) is where ``init_params`` puts the parameters."""

    def __init__(self, num_qubits: int,
                 edges: Sequence[Tuple[int, int, float]], depth: int,
                 mesh=None, device=None):
        self.num_qubits = int(num_qubits)
        self.edges = tuple((int(i), int(j), float(w)) for i, j, w in edges)
        self.depth = int(depth)
        self.mesh = mesh
        self.device = _model_device(device, mesh)

    @property
    def num_params(self) -> int:
        return 2 * self.depth  # (gamma, beta) per layer

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=None) -> torch.Tensor:
        """0.1 times standard normal parameters from ``generator``."""
        dtype = dtype or precision.real_dtype()
        p = torch.randn(self.num_params, generator=generator,
                        dtype=torch.float64)
        return (0.1 * p).to(dtype=dtype, device=self.device)

    def _cost_2d(self, dtype, device):
        """The cut size c(z) as a (2^hi, 2^lo) tensor from bit views."""
        n = self.num_qubits
        c = torch.zeros((1, 1), dtype=dtype, device=device)
        for i, j, w in self.edges:
            c = c + w * (kernels.bit_2d(n, i, device)
                         ^ kernels.bit_2d(n, j, device)).to(dtype)
        return c

    def state(self, params):
        """|psi(gamma, beta)> after p alternating cost and mixer layers."""
        n = self.num_qubits
        amps = kernels.init_plus_state(1 << n, params.dtype, params.device)
        cost = self._cost_2d(params.dtype, params.device)
        hi, lo = kernels._split2(n)
        p = params.reshape(self.depth, 2)
        for layer in range(self.depth):
            gamma, beta = p[layer, 0], p[layer, 1]
            # cost phase: elementwise exp(-i gamma c(z))
            view = amps.reshape(2, 1 << hi, 1 << lo)
            ang = -gamma * cost
            re = view[0] * torch.cos(ang) - view[1] * torch.sin(ang)
            im = view[0] * torch.sin(ang) + view[1] * torch.cos(ang)
            amps = torch.stack([re, im]).reshape(2, -1)
            # mixer: RX(2 beta) = cos(b) I - i sin(b) X on every qubit
            cb, sb = torch.cos(beta), torch.sin(beta)
            zero = torch.zeros_like(cb)
            rx = torch.stack([
                torch.stack([torch.stack([cb, zero]),
                             torch.stack([zero, cb])]),
                torch.stack([torch.stack([zero, -sb]),
                             torch.stack([-sb, zero])]),
            ])
            for q in range(n):
                amps = kernels.apply_matrix(amps, rx, num_qubits=n,
                                            targets=(q,))
        return amps

    def expected_cut(self, params):
        """<psi| C |psi>, the quantity QAOA maximises."""
        amps = self.state(params)
        cost = self._cost_2d(params.dtype, params.device)
        hi, lo = kernels._split2(self.num_qubits)
        view = amps.reshape(2, 1 << hi, 1 << lo)
        probs = view[0] * view[0] + view[1] * view[1]
        return torch.sum(probs * cost)

    def loss(self, params):
        return -self.expected_cut(params)

    def make_train_step(self, optimizer: torch.optim.Optimizer):
        """One (cut, gradient, update) step: ``step(params)`` on the leaf
        tensor ``optimizer`` holds, updated in place; returns the expected
        cut before the update."""

        def step(params):
            optimizer.zero_grad()
            neg_cut = self.loss(params)
            neg_cut.backward()
            optimizer.step()
            return -neg_cut.detach()

        return step


def random_graph(num_qubits: int, num_edges: int, seed: int = 0):
    """Random weighted graph for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    edges = set()
    while len(edges) < num_edges:
        i, j = rng.integers(0, num_qubits, 2)
        if i != j:
            edges.add((min(i, j), max(i, j)))
    return [(i, j, float(rng.uniform(0.5, 1.5))) for i, j in sorted(edges)]
