"""The port's examples (examples/torch/) on the CPU, held to the
reference's examples (examples/) run with the same inputs.

Each port example runs as tests/test_examples.py runs the reference's: a
subprocess with QT_EXAMPLES_CPU=1 (the example then asks for
``createQuESTEnv(device="cpu")``), at the same sizes and modes, and must
print the same lines.  Then the numbers:
* the tutorial's amplitude and probability lines before its measurements
  within 1e-6 (its measured outcomes come from the default seed);
* Bernstein-Vazirani's ``recovered = 17``;
* phase estimation's estimate and ``|error| = 0.0``, in both modes;
* Grover's "prob of solution" per repetition within 1e-6 (it does not
  depend on the random solution), in both modes;
* the Trotter ``<H>`` and ``<Mx>`` lines within 1e-5, with both packages
  at precision 2 (at float32 the two packages' sums, taken in other
  orders, part by up to 1.5e-5 by t = 0.5, each within 6e-5 of float64);
* shot sampling's histogram equal (both draw from ``seedQuEST([1234])``
  on the stream the port matched bit for bit);
* VQE and QAOA, whose initial parameters come from other generators:
  the final energy below the first and at or above the exact ground
  energy, and the expected cut rising and at most the total weight.
A printed number carries 6 significant digits (``:g``) or 6 decimals, so
each comparison allows the print's rounding beside its tolerance.
Without QT_EXAMPLES_CPU an example runs on the card, and raises here.
"""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRECISION = {
    "port": "import quest_tpu_torch as qt; qt.set_precision({p})",
    "ref": ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import quest_tpu as qt; qt.set_precision({p})"),
}


def _run(pkg, script, *args, env_extra=None, precision=None, cpu=True):
    """Run the port's (``pkg`` "port") or the reference's ("ref") example
    in a subprocess; with ``precision``, set first through the package's
    set_precision."""
    env = dict(os.environ)
    env.pop("QT_EXAMPLES_CPU", None)
    # one thread for torch, one CPU device for JAX (not the suite's
    # 8-device mesh): the examples' numbers do not depend on either, and
    # the suite's workers keep their cores
    env["OMP_NUM_THREADS"] = "1"
    env["XLA_FLAGS"] = " ".join(
        [f for f in env.get("XLA_FLAGS", "").split()
         if not f.startswith("--xla_force_host_platform_device_count")]
        + ["--xla_cpu_multi_thread_eigen=false",
           "intra_op_parallelism_threads=1"])
    if cpu:
        env["QT_EXAMPLES_CPU"] = "1"
    env.update(env_extra or {})
    path = os.path.join(REPO, "examples", *(("torch",) if pkg == "port"
                                            else ()), script)
    cmd = [sys.executable, path, *args]
    if precision is not None:
        cmd = [sys.executable, "-c",
               _PRECISION[pkg].format(p=precision) + "\n"
               "import runpy, sys\n"
               f"sys.argv = {[path, *args]!r}\n"
               f"runpy.run_path({path!r}, run_name='__main__')"]
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env, cwd=REPO)
    if cpu:
        assert r.returncode == 0, r.stderr
    return r


def _numbers(text, key):
    """The first number after ``key`` on each line holding it."""
    out = []
    for line in text.splitlines():
        if key in line:
            m = re.search(r"[-+]?\d+(\.\d*)?(e[-+]?\d+)?",
                          line.split(key, 1)[1])
            out.append(m.group(0))
    return out


def _rounding(s):
    """A unit in the last digit the number ``s`` was printed to (two
    prints, each rounded by half of it): ``:g`` keeps 6 significant
    digits and drops trailing zeros, the fixed formats 6 decimals."""
    x = float(s)
    mant = s.lower().split("e")[0]
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    if "e" in s.lower() or decimals < 6:
        return 10.0 ** (math.floor(math.log10(abs(x))) - 5) if x else 0.0
    return 10.0 ** -decimals


def _assert_printed_close(got, want, tol):
    assert len(got) == len(want) and got, (got, want)
    for g, w in zip(got, want):
        slack = tol + max(_rounding(g), _rounding(w))
        assert abs(float(g) - float(w)) <= slack, (g, w, slack)


def test_tutorial():
    r = _run("port", "tutorial_example.py")
    assert "Probability amplitude of |111>" in r.stdout
    ref = _run("ref", "tutorial_example.py")
    for key in ("Probability amplitude of |111>:",
                "Probability of qubit 2 being in state 1:"):
        _assert_printed_close(_numbers(r.stdout, key),
                              _numbers(ref.stdout, key), 1e-6)


def test_bernstein_vazirani():
    r = _run("port", "bernstein_vazirani.py")
    assert "recovered = 17" in r.stdout
    assert "recovered = 17" in _run("ref", "bernstein_vazirani.py").stdout


@pytest.mark.parametrize("mode", [[], ["--fused"]])
def test_grover(mode):
    env = {"QT_GROVER_QUBITS": "7"}
    r = _run("port", "grovers_search.py", *mode, env_extra=env)
    assert "prob of solution" in r.stdout
    ref = _run("ref", "grovers_search.py", *mode, env_extra=env)
    _assert_printed_close(_numbers(r.stdout, "> = ") or
                          _numbers(r.stdout, "reps = "),
                          _numbers(ref.stdout, "> = ") or
                          _numbers(ref.stdout, "reps = "), 1e-6)
    assert len(_numbers(r.stdout, "prob of solution")) == \
        (1 if mode else 9)


def _ground_energy(n, codes, coeffs):
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]]),
              np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
    h = np.zeros((1 << n, 1 << n), complex)
    for row, c in zip(codes, coeffs):
        term = np.ones((1, 1))
        for q in reversed(range(n)):        # qubit 0 least significant
            term = np.kron(term, paulis[row[q]])
        h += c * term
    return float(np.linalg.eigvalsh(h)[0])


def test_vqe_train():
    from quest_tpu_torch.models import vqe

    r = _run("port", "vqe_train.py", env_extra={"QT_VQE_QUBITS": "6"})
    assert "done; final energy" in r.stdout
    energies = [float(e) for e in _numbers(r.stdout, "energy =")]
    final = float(_numbers(r.stdout, "final energy")[0])
    codes, coeffs = vqe.random_hamiltonian(6, 6, seed=11)
    ground = _ground_energy(6, codes, coeffs)
    assert final < energies[0]
    assert final >= ground - 1e-5, (final, ground)


def test_trotter_evolution():
    env = {"QT_EVOLVE_QUBITS": "8", "QT_EVOLVE_STEPS": "10"}
    r = _run("port", "trotter_evolution.py", env_extra=env)
    assert "energy drift" in r.stdout and "OK" in r.stdout
    port64 = _run("port", "trotter_evolution.py", env_extra=env,
                  precision=2)
    ref64 = _run("ref", "trotter_evolution.py", env_extra=env, precision=2)
    for key in ("<H>=", "<Mx>="):
        _assert_printed_close(_numbers(port64.stdout, key),
                              _numbers(ref64.stdout, key), 1e-5)
        # the shipped float32 run within 1e-4 of float64
        _assert_printed_close(_numbers(r.stdout, key),
                              _numbers(ref64.stdout, key), 1e-4)


def test_qaoa_maxcut():
    r = _run("port", "qaoa_maxcut.py", env_extra={"QT_QAOA_QUBITS": "6"})
    assert "expected cut" in r.stdout
    cuts = [float(c) for c in _numbers(r.stdout, "expected cut =")]
    total = float(_numbers(r.stdout, "total weight")[0])
    assert len(cuts) == 7
    assert cuts[0] < cuts[-1] <= total


@pytest.mark.parametrize("mode", [[], ["--fused"]])
def test_phase_estimation(mode):
    # phi = 11/64 is exactly representable with 6 counting qubits, so the
    # measured estimate is deterministic
    env = {"QPE_QUBITS": "6", "QPE_PHI": "0.171875"}
    r = _run("port", "phase_estimation.py", *mode, env_extra=env)
    assert "estimate" in r.stdout
    assert "|error| = 0.0" in r.stdout
    ref = _run("ref", "phase_estimation.py", *mode, env_extra=env)
    assert _numbers(r.stdout, ") = ") == _numbers(ref.stdout, ") = ") \
        == ["0.171875"]


def test_shot_sampling():
    env = {"QT_SHOT_QUBITS": "6", "QT_SHOT_COUNT": "40"}
    r = _run("port", "shot_sampling.py", env_extra=env)
    assert "top-2 mass" in r.stdout
    assert r.stdout == _run("ref", "shot_sampling.py", env_extra=env).stdout


def test_examples_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the examples bind it")
    r = _run("port", "bernstein_vazirani.py", cpu=False)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
