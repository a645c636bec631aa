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
- phase functions -> multi-line comments rendering the applied phase
  symbolically, its sub-registers and overrides (qasm_recordPhaseFunc,
  qasm_recordMultiVarPhaseFunc, qasm_recordNamedPhaseFunc,
  QuEST_qasm.c:490-891).
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

    # -- phase-function records (multi-line symbolic comments) -----------
    # Mirrors the reference's record shapes (qasm_recordPhaseFunc /
    # qasm_recordMultiVarPhaseFunc / qasm_recordNamedPhaseFunc,
    # QuEST_qasm.c:490-891): the applied scalar rendered symbolically with
    # per-register symbols, the informing sub-registers, and overrides.

    def _sym(self, num_regs: int, r: int) -> str:
        if num_regs <= 7:
            return "xyztrvu"[r]
        if num_regs <= 24:
            return "abcdefghjklmnpqrstuvwxyz"[r]
        return f"x{r}"

    def _enc_str(self, encoding: int) -> str:
        return "an unsigned" if encoding == 0 else "a two's complement"

    def _poly_str(self, coeffs, exponents, sym: str, first_signed=True) -> str:
        parts = []
        for t, (c, e) in enumerate(zip(coeffs, exponents)):
            mag = c if (t == 0 and first_signed) else abs(c)
            term = (f"{_fmt(mag)} {sym}^{_fmt(e)}" if e > 0
                    else f"{_fmt(mag)} {sym}^({_fmt(e)})")
            if t:
                parts.append(" + " if c > 0 else " - ")
            parts.append(term)
        return "".join(parts)

    def _override_lines(self, regs, inds, phases):
        if len(phases) == 0:
            return
        self.comment("  though with overrides")
        nr = len(regs)
        for row, ph in zip(inds, phases):
            if nr == 1:
                ket = f"|{int(row[0])}>"
            else:
                ket = "|" + ", ".join(
                    f"{self._sym(nr, r)}={int(row[r])}" for r in range(nr)) + ">"
            val = f"exp(i {_fmt(ph)})" if ph >= 0 else f"exp(i ({_fmt(ph)}))"
            self._add(f"//     {ket} -> {val}")

    def _reg_lines(self, regs, encoding):
        self.comment(
            f"  upon substates informed by qubits (under "
            f"{self._enc_str(encoding)} binary encoding)")
        nr = len(regs)
        for r, qs in enumerate(regs):
            body = ", ".join(str(q) for q in qs)
            self._add(f"//     |{self._sym(nr, r)}> = {{{body}}}")

    def phase_func(self, qubits, encoding, coeffs, exponents,
                   override_inds, override_phases):
        if not self.is_logging:
            return
        self.comment(
            "Here, applyPhaseFunc() multiplied a complex scalar of the form")
        self._add(f"//     exp(i ({self._poly_str(coeffs, exponents, 'x')}))")
        self.comment(
            f"  upon every substate |x>, informed by qubits (under "
            f"{self._enc_str(encoding)} binary encoding)")
        self._add("//     {" + ", ".join(str(q) for q in qubits) + "}")
        self._override_lines([qubits], override_inds, override_phases)

    def multi_var_phase_func(self, regs, encoding, coeffs, exponents,
                             terms_per_reg, override_inds, override_phases):
        if not self.is_logging:
            return
        self.comment("Here, applyMultiVarPhaseFunc() multiplied a complex "
                     "scalar of the form")
        self.comment("    exp(i (")
        nr = len(regs)
        pos = 0
        for r, nt in enumerate(terms_per_reg):
            cs = coeffs[pos:pos + nt]
            es = exponents[pos:pos + nt]
            pos += nt
            lead = " + " if cs[0] > 0 else " - "
            body = self._poly_str(
                [abs(cs[0])] + list(cs[1:]), es, self._sym(nr, r))
            tail = " ))" if r == nr - 1 else ""
            self._add(f"//         {lead}{body}{tail}")
        self._reg_lines(regs, encoding)
        self._override_lines(regs, override_inds, override_phases)

    def named_phase_func(self, regs, encoding, func_code, params,
                         override_inds, override_phases):
        if not self.is_logging:
            return
        from .ops import phasefunc as PF

        self.comment(
            "Here, applyNamedPhaseFunc() multiplied a complex scalar of form")
        nr = len(regs)
        syms = [self._sym(nr, r) for r in range(nr)]
        params = list(params)
        scaled = func_code in (
            PF.SCALED_NORM, PF.SCALED_INVERSE_NORM,
            PF.SCALED_INVERSE_SHIFTED_NORM, PF.SCALED_PRODUCT,
            PF.SCALED_INVERSE_PRODUCT, PF.SCALED_DISTANCE,
            PF.SCALED_INVERSE_DISTANCE, PF.SCALED_INVERSE_SHIFTED_DISTANCE)
        coef = ""
        if scaled and params:
            coef = (f"{_fmt(params[0])} " if params[0] > 0
                    else f"({_fmt(params[0])}) ")
        norm_family = func_code in (
            PF.NORM, PF.SCALED_NORM, PF.INVERSE_NORM, PF.SCALED_INVERSE_NORM,
            PF.SCALED_INVERSE_SHIFTED_NORM)
        prod_family = func_code in (
            PF.PRODUCT, PF.SCALED_PRODUCT, PF.INVERSE_PRODUCT,
            PF.SCALED_INVERSE_PRODUCT)
        if norm_family:
            if func_code in (PF.NORM, PF.SCALED_NORM):
                opener, closer = "sqrt(", ")"
            elif func_code == PF.INVERSE_NORM:
                opener, closer = "1 / sqrt(", ")"
            else:
                opener, closer = "/ sqrt(", ")"
            if func_code == PF.SCALED_INVERSE_SHIFTED_NORM:
                terms = []
                for r, s in enumerate(syms):
                    d = params[2 + r] if len(params) > 2 + r else 0.0
                    terms.append(f"({s}^2-{_fmt(abs(d))})" if d >= 0
                                 else f"({s}^2+{_fmt(abs(d))})")
                body = " + ".join(terms)
            else:
                body = " + ".join(f"{s}^2" for s in syms)
            self._add(f"//     exp(i {coef}{opener}{body}{closer})")
        elif prod_family:
            if func_code == PF.INVERSE_PRODUCT:
                opener, closer = "1 / (", ")"
            elif func_code == PF.SCALED_INVERSE_PRODUCT:
                opener, closer = "/ (", ")"
            else:
                opener, closer = "", ""
            body = " ".join(syms)
            self._add(f"//     exp(i {coef}{opener}{body}{closer})")
        else:  # distance family: pairs (x1-x2)^2 + ...
            if func_code in (PF.DISTANCE, PF.SCALED_DISTANCE):
                opener, closer = "sqrt(", ")"
            elif func_code == PF.INVERSE_DISTANCE:
                opener, closer = "1 / sqrt(", ")"
            else:
                opener, closer = "/ sqrt(", ")"
            terms = []
            for k in range(nr // 2):
                a, b = syms[2 * k], syms[2 * k + 1]
                if func_code == PF.SCALED_INVERSE_SHIFTED_DISTANCE:
                    d = params[2 + k] if len(params) > 2 + k else 0.0
                    terms.append(f"({a}-{b}-{_fmt(d)})^2" if d >= 0
                                 else f"({a}-{b}+{_fmt(abs(d))})^2")
                else:
                    terms.append(f"({a}-{b})^2")
            self._add(f"//     exp(i {coef}{opener}{' + '.join(terms)}{closer})")
        # divergence-override parameter (the value at singular points)
        if func_code in (PF.INVERSE_NORM, PF.INVERSE_PRODUCT,
                         PF.INVERSE_DISTANCE) and params:
            self.comment(f"  (interpreted as {_fmt(params[0])} at "
                         "singularities)")
        self._reg_lines(regs, encoding)
        if func_code in (PF.SCALED_INVERSE_SHIFTED_NORM,
                         PF.SCALED_INVERSE_SHIFTED_DISTANCE):
            self.comment("  with the additional parameters")
            nd = nr if func_code == PF.SCALED_INVERSE_SHIFTED_NORM else nr // 2
            for k in range(nd):
                d = params[2 + k] if len(params) > 2 + k else 0.0
                self._add(f"//     delta{k} = {_fmt(d)}")
        self._override_lines(regs, override_inds, override_phases)

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
