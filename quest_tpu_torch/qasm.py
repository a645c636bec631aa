"""OPENQASM 2.0 circuit logger.

Python re-implementation of the reference's QASM subsystem
(QuEST_qasm.{h,c}), copied from the JAX package's logger for the gate
records this package emits.  Behavioural parity:

- gate-name table matches QuEST_qasm.c:39-53; controls stack a "c" prefix
  per control qubit (addGateToQASM, QuEST_qasm.c:139-177).
- 2x2 unitaries are decomposed to U(rz2, ry, rz1) via ZYZ angles
  (QuEST_qasm.c:196-237).
- controlled phase-shifts / unitaries emit an extra uncontrolled Rz to
  restore the global phase the controlled decomposition discards
  (QuEST_qasm.c:248-299,341-361).
- control-on-0 is wrapped in an X sandwich (QuEST_qasm.c:363-380).
- measurement -> "measure q[i] -> c[i]" (:411-420); initZero -> "reset"
  (:428-434); other ops are logged as comments (QuEST_qasm.c:121).

The phase-function records arrive with the phase-function API.
"""

from __future__ import annotations

import cmath
import math
from typing import Optional, Sequence

import numpy as np


class QASMLogger:
    def __init__(self, num_qubits: int):
        self.is_logging = False
        self.num_qubits = num_qubits
        self.lines = [
            "OPENQASM 2.0;",
            f"qreg q[{num_qubits}];",
            f"creg c[{num_qubits}];",
        ]

    # -- recording control (QuEST.h:3351-3390) --
    def start(self):
        self.is_logging = True

    def stop(self):
        self.is_logging = False

    def clear(self):
        self.lines = self.lines[:3]

    def __str__(self):
        return "\n".join(self.lines) + "\n"

    # -- emitters --
    def _add(self, line: str):
        self.lines.append(line)

    def comment(self, text: str):
        if self.is_logging:
            self._add(f"// {text}")

    def _gate_str(self, name: str, controls: Sequence[int], target: int,
                  params: Sequence[float] = ()) -> str:
        full = "c" * len(controls) + name
        if params:
            full += "(" + ",".join(_fmt(p) for p in params) + ")"
        qubits = ",".join(f"q[{c}]" for c in controls)
        if qubits:
            qubits += ","
        qubits += f"q[{target}]"
        return f"{full} {qubits};"

    def gate(self, name: str, controls: Sequence[int] = (), target: int = 0,
             params: Sequence[float] = (),
             control_states: Optional[Sequence[int]] = None):
        if not self.is_logging:
            return
        zero_ctrls = (
            [c for c, s in zip(controls, control_states) if s == 0]
            if control_states is not None
            else []
        )
        for c in zero_ctrls:
            self._add(self._gate_str("x", (), c))
        self._add(self._gate_str(name, controls, target, params))
        for c in zero_ctrls:
            self._add(self._gate_str("x", (), c))

    def unitary_2x2(self, matrix, controls: Sequence[int], target: int,
                    control_states: Optional[Sequence[int]] = None):
        """Decompose to U(rz2, ry, rz1); when controlled, also emit the
        global-phase-restoring Rz (QuEST_qasm.c:341-361)."""
        if not self.is_logging:
            return
        m = np.asarray(matrix, dtype=complex)
        alpha, beta, phase = _complex_pair_and_phase(m)
        rz2, ry, rz1 = _zyz_from_complex_pair(alpha, beta)
        if controls and abs(phase) > 1e-12:
            self._add(self._gate_str("Rz", (), controls[0], [2 * phase]))
        self.gate("U", controls, target, [rz2, ry, rz1], control_states)

    def phase_shift(self, angle: float, controls: Sequence[int], target: int):
        """Rz with half-angle global-phase fix (QuEST_qasm.c:248-299)."""
        if not self.is_logging:
            return
        if controls:
            self._add(self._gate_str("Rz", (), controls[0], [angle / 2]))
        self.gate("Rz", controls, target, [angle])

    def measure(self, qubit: int):
        if self.is_logging:
            self._add(f"measure q[{qubit}] -> c[{qubit}];")

    def init_zero(self):
        if self.is_logging:
            self._add("reset q;")


def _fmt(p: float) -> str:
    return f"{p:g}"


def _complex_pair_and_phase(m):
    """Factor a 2x2 unitary into global phase * [[a, -b*],[b, a*]]
    (getComplexPairAndPhaseFromUnitary, QuEST_qasm.c)."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    phase = cmath.phase(det) / 2
    g = cmath.exp(-1j * phase)
    return m[0, 0] * g, m[1, 0] * g, phase


def _zyz_from_complex_pair(alpha, beta):
    """U = Rz(rz2) Ry(ry) Rz(rz1) angles from a (alpha, beta) Givens pair
    (getZYZRotAnglesFromComplexPair, QuEST_qasm.c:196-237)."""
    alpha_mag = abs(alpha)
    ry = 2 * math.acos(min(1.0, max(0.0, alpha_mag)))
    alpha_phase = cmath.phase(alpha) if alpha_mag > 1e-15 else 0.0
    beta_phase = cmath.phase(beta) if abs(beta) > 1e-15 else 0.0
    rz2 = -alpha_phase + beta_phase
    rz1 = -alpha_phase - beta_phase
    return rz2, ry, rz1
