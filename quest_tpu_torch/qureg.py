"""The quantum register.

``Qureg`` (QuEST.h:322-353) holds one real SoA tensor of shape
``(2, 2^numQubitsInStateVec)`` on the env's device: channel 0/1 = real /
imaginary, qubit q = bit q of the flat index (little-endian), the JAX
package's layout.  A density matrix is a 2N-qubit vector, flattened
column-major (ket = low bits), as in the reference.  On an env of R = 2^r
shards a register of at least R amplitudes holds a
``parallel.mesh.ShardedAmps`` instead: R shard tensors of shape
``(2, 2^nloc)``, shard s holding the global indices
``[s 2^nloc, (s + 1) 2^nloc)``; a smaller register is replicated (one
tensor on the env's device, as the JAX package's ``Qureg.sharding()``
replicates it).  ``PauliHamil`` (QuEST.h:277) is a host-side term table;
``DiagonalOp`` (QuEST.h:297) a diagonal operator's real and imaginary
(2^n,) vectors on the device.
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
        self._amps = None
        # governor.SpillHandle while the amplitudes live on the host (the
        # memory governor spilled the register; the next read restores)
        self._spill = None
        self._fusion = None  # FusionBuffer while a gateFusion context is active
        # fusion drains executed on this register: the resilience layer's
        # window-boundary count (a checkpoint never lands mid-window)
        self._drain_count = 0
        # live logical->physical qubit permutation of a sharded register
        # (None = canonical order): _perm[q] is the physical state-vector
        # bit holding logical bit q.  The drain and the eager relocations
        # leave the state permuted; the ``amps`` getter restores
        # canonical order with one remap (quest_tpu/qureg.py:98-110)
        self._perm: Optional[tuple] = None
        # last-use tick per logical state-vector bit: eager relocations
        # evict the least recently used residents
        self._last_use: dict = {}
        self._use_clock: int = 0

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def num_amps_total(self) -> int:
        return 1 << self.num_qubits_in_state_vec

    @property
    def shard_bits(self) -> int:
        """Leading state-vector bits held as shard-index bits: 0 on a
        one-shard env and for a replicated register."""
        nd = self.env.num_devices
        if nd <= 1 or self.num_amps_total < nd:
            return 0
        return nd.bit_length() - 1

    @property
    def is_sharded(self) -> bool:
        return self.shard_bits > 0

    @property
    def num_chunks(self) -> int:
        return self.env.num_devices

    @property
    def num_amps_per_chunk(self) -> int:
        return self.num_amps_total >> self.shard_bits

    @property
    def amps(self):
        """The amplitudes in canonical qubit order: pending fused gates
        drain first, then a live permutation is undone with one remap, so
        every reader sees reference semantics; a register the memory
        governor spilled to the host is restored first.  A (2, 2^n)
        tensor, or a ShardedAmps on a sharded register."""
        if self._amps is None:
            from . import governor
            from .validation import QuESTError

            if not governor.restore_register(self):
                raise QuESTError(
                    "Qureg: the register has been destroyed (destroyQureg) "
                    "or never initialised.")
        if self._fusion is not None and self._fusion.gates:
            from . import fusion

            fusion.drain(self)
        if self._perm is not None:
            from .parallel import dist

            self._amps = dist.remap_sharded(
                self._amps, num_qubits=self.num_qubits_in_state_vec,
                sigma=dist.canonical_sigma(self._perm))
            self._perm = None
        return self._amps

    @amps.setter
    def amps(self, value):
        if self._fusion is not None and self._fusion.gates:
            # a pure overwrite makes pending gates unobservable: discard
            # them instead of computing a dead result
            self._fusion.gates.clear()
        # an overwrite is in canonical order; only _set_amps_permuted
        # carries a permutation
        self._perm = None
        self._spill = None  # an overwrite drops any host snapshot
        self._amps = value

    def _amps_raw(self):
        """The amplitudes without restoring canonical order (pending
        fused gates still drain first)."""
        if self._amps is None:
            from . import governor

            if not governor.restore_register(self):
                return self.amps  # raises the destroyed-register error
        if self._fusion is not None and self._fusion.gates:
            from . import fusion

            fusion.drain(self)
        return self._amps

    def _set_amps_permuted(self, value, perm) -> None:
        """Rebind amplitudes held under logical->physical ``perm`` (None
        or the identity: canonical), keeping the permutation.  A register
        on one device keeps no permutation (its drains plan in logical
        order): a permuted state restored onto it (a checkpoint written
        on a mesh) is put in canonical order here, one local transpose."""
        n = self.num_qubits_in_state_vec
        if perm is not None and tuple(perm) == tuple(range(n)):
            perm = None
        if perm is not None and not self.is_sharded:
            from .ops import kernels

            perm = tuple(int(p) for p in perm)
            if value.dim() == 3:
                value = torch.stack([kernels.permute_qubits(
                    v, num_qubits=n, perm=perm) for v in value])
            else:
                value = kernels.permute_qubits(value, num_qubits=n,
                                               perm=perm)
            perm = None
        self._spill = None
        self._amps = value
        self._perm = None if perm is None else tuple(perm)

    def bind_checkpoint_state(self, amps, perm, dtype) -> None:
        """Rebind to checkpointed state: raw (possibly permuted)
        amplitudes, the live logical->physical permutation and the type
        the snapshot was taken at (the restore half of resilience.py's
        generation protocol).  Unlike the ``amps`` setter this keeps the
        permutation; pending fused gates are discarded (they predate the
        snapshot)."""
        if self._fusion is not None and self._fusion.gates:
            self._fusion.gates.clear()
        self.dtype = dtype
        self._set_amps_permuted(amps, perm)

    def _phys_bits(self, bits) -> tuple:
        """Physical positions of logical state-vector bits under the live
        permutation."""
        if self._perm is None:
            return tuple(bits)
        return tuple(self._perm[b] for b in bits)


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
