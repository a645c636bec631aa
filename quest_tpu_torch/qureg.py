"""The quantum register.

``Qureg`` (QuEST.h:322-353) holds one real SoA tensor of shape
``(2, 2^numQubitsInStateVec)`` on the env's device: channel 0/1 = real /
imaginary, qubit q = bit q of the flat index (little-endian), the JAX
package's layout.  A density matrix is a 2N-qubit vector, flattened
column-major (ket = low bits), as in the reference.  ``PauliHamil``
(QuEST.h:277) is a host-side term table; ``DiagonalOp`` (QuEST.h:297) a
diagonal operator's real and imaginary (2^n,) vectors on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import precision
from .env import QuESTEnv
from .qasm import QASMLogger


class Qureg:
    """A quantum register: pure state-vector or density matrix."""

    def __init__(self, num_qubits: int, env: QuESTEnv, is_density_matrix: bool):
        self.is_density_matrix = bool(is_density_matrix)
        self.num_qubits_represented = int(num_qubits)
        self.num_qubits_in_state_vec = (
            (2 if is_density_matrix else 1) * int(num_qubits))
        self.env = env
        self.dtype = precision.real_dtype()
        self.qasm_log = QASMLogger(num_qubits)
        self._amps: Optional[torch.Tensor] = None
        self._fusion = None  # FusionBuffer while a gateFusion context is active

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def num_amps_total(self) -> int:
        return 1 << self.num_qubits_in_state_vec

    @property
    def amps(self) -> torch.Tensor:
        """The (2, 2^n) amplitudes; pending fused gates drain first, so
        every reader sees reference semantics."""
        if self._amps is None:
            from .validation import QuESTError

            raise QuESTError(
                "Qureg: the register has been destroyed (destroyQureg) "
                "or never initialised.")
        if self._fusion is not None and self._fusion.gates:
            from . import fusion

            fusion.drain(self)
        return self._amps

    @amps.setter
    def amps(self, value: Optional[torch.Tensor]):
        if self._fusion is not None and self._fusion.gates:
            # a pure overwrite makes pending gates unobservable: discard
            # them instead of computing a dead result
            self._fusion.gates.clear()
        self._amps = value


class PauliHamil:
    """Real-weighted sum of Pauli products (QuEST.h:277): host NumPy
    ``pauli_codes`` (T, n) int32 and ``term_coeffs`` (T,) float64, as in the
    reference package."""

    def __init__(self, num_qubits: int, num_sum_terms: int):
        self.num_qubits = int(num_qubits)
        self.num_sum_terms = int(num_sum_terms)
        self.pauli_codes = np.zeros((num_sum_terms, num_qubits),
                                    dtype=np.int32)
        self.term_coeffs = np.zeros((num_sum_terms,), dtype=np.float64)


class DiagonalOp:
    """Diagonal operator on the full Hilbert space (QuEST.h:297): ``real``
    and ``imag`` (2^numQubits,) tensors of the working precision's type on
    the env's device, zero at creation (the JAX package's SoA vectors)."""

    def __init__(self, num_qubits: int, env: QuESTEnv):
        self.num_qubits = int(num_qubits)
        self.env = env
        dim = 1 << self.num_qubits
        rdt = precision.real_dtype()
        self.real = torch.zeros((dim,), dtype=rdt, device=env.device)
        self.imag = torch.zeros((dim,), dtype=rdt, device=env.device)

    @property
    def num_elems_per_chunk(self) -> int:
        return 1 << self.num_qubits
