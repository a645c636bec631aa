"""quest_tpu_torch stands alone: it imports neither JAX nor the JAX
package, uses the CUDA card unless the CPU is asked for, and its kernel
wrappers take their plain versions only for tensors on the CPU (where the
launch counters stay at 0)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import quest_tpu_torch as tq
from quest_tpu_torch import circuit as C
from quest_tpu_torch.ops import bigstate, build, fused, paulis

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "quest_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "quest_tpu", "orbax", "tensorstore")


def test_import_leaves_jax_out():
    code = ("import sys, quest_tpu_torch, quest_tpu_torch.interop, "
            "quest_tpu_torch.models.circuits, quest_tpu_torch.ops.paulis, "
            "quest_tpu_torch.ops.build, quest_tpu_torch.ops.bigstate, "
            "quest_tpu_torch.ops.phasefunc, "
            "quest_tpu_torch.models.hamiltonians, "
            "quest_tpu_torch.ops.density, quest_tpu_torch.models.noise, "
            "quest_tpu_torch.rng, quest_tpu_torch.ops.threefry, "
            "quest_tpu_torch.ops.measurement, quest_tpu_torch.checkpoint, "
            "quest_tpu_torch.debug, quest_tpu_torch.resilience, "
            "quest_tpu_torch.telemetry, quest_tpu_torch.utils.profiling, "
            "quest_tpu_torch.serve, quest_tpu_torch.ops.stream, "
            "quest_tpu_torch.probes.profile_dma, "
            "quest_tpu_torch.probes.kernel_microbench, "
            "quest_tpu_torch.probes.probe_kernel_variants, "
            "quest_tpu_torch.probes.profile_rank_kernels, "
            "quest_tpu_torch.probes.probe_flip_pallas\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r})\n"
            "print(','.join(bad))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) +
                         [REPO / "chip_smoke.py"] +
                         sorted((REPO / "examples" / "torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & set(_FORBIDDEN), path


def test_default_env_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default env binds it")
    with pytest.raises(tq.QuESTError, match="device=\"cpu\""):
        tq.createQuESTEnv()


def test_cpu_env_is_explicit():
    env = tq.createQuESTEnv(device="cpu")
    assert env.device.type == "cpu"
    assert "Backend=cpu" in tq.getEnvironmentString(env)


def _op(rng, k):
    a = rng.standard_normal((1, 2, 128, 128))
    return ("winfused", k, a, a.copy(), True, True, None)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    fused.reset_launch_counts()
    rng = np.random.default_rng(0)
    n = 15
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    op = _op(rng, 8)
    y = fused.apply_window_stack(x, op[2], op[3], None, num_qubits=n, k=8)
    assert torch.equal(y, fused.window_pass_plain(x, op[2], op[3], None,
                                                  num_qubits=n, k=8))
    group = [_op(rng, 7), _op(rng, 8)]
    y2 = fused.apply_window_megastack(x, group, num_qubits=n)
    assert torch.equal(y2, fused.megawin_plain(x, group, num_qubits=n))
    q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
    with tq.gateFusion(q):
        for t in range(n):
            tq.hadamard(q, t)
    assert abs(tq.calcTotalProb(q) - 1.0) < 1e-5
    assert (fused.LAUNCHES["K1"], fused.LAUNCHES["K2"]) == (0, 0)


def test_cluster_wrappers_and_paged_drain_on_cpu_launch_nothing(monkeypatch):
    fused.reset_launch_counts()
    rng = np.random.default_rng(5)
    n = 15
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    a = rng.standard_normal((4, 2, 128, 128))
    b = rng.standard_normal((4, 2, 128, 128))
    assert torch.equal(fused.apply_cluster_stack(x, a, b, num_qubits=n),
                       fused.cluster_stack_plain(x, a, b, num_qubits=n))
    assert torch.equal(
        fused.apply_swap_cluster_stack(x, a, b, num_qubits=n, h=14, b=9,
                                       m=1),
        fused.swap_cluster_stack_plain(x, a, b, num_qubits=n, h=14, b=9,
                                       m=1))
    assert torch.equal(fused.apply_cluster_pair(x, a[0], b[0], num_qubits=n),
                       fused.cluster_stack_plain(x, a[:1], b[:1],
                                                 num_qubits=n))
    monkeypatch.setenv("QT_PLANNER", "paged")
    q = tq.createQureg(16, tq.createQuESTEnv(device="cpu"))
    with tq.gateFusion(q):
        for t in range(16):
            tq.hadamard(q, t)
        tq.controlledNot(q, 15, 0)
    assert abs(tq.calcTotalProb(q) - 1.0) < 1e-5
    assert fused.LAUNCHES["K11"] == fused.LAUNCHES["K12"] == 0
    assert all(v == 0 for v in fused.LAUNCHES.values())


def test_pauli_wrappers_on_cpu_take_the_plain_path_and_launch_nothing():
    paulis.reset_launch_counts()
    rng = np.random.default_rng(3)
    n = 15
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    codes = rng.integers(0, 4, (3, n))
    term = paulis.pauli_term(codes[0], dtype=torch.float64, theta=0.3)
    assert torch.equal(paulis.direct_rotation(x, term, num_qubits=n),
                       paulis.direct_rotation_plain(x, term, num_qubits=n))
    assert torch.equal(paulis.expec_term(x, term, num_qubits=n),
                       paulis.expec_term_plain(x, term, num_qubits=n))
    paulis.trotter_scan(x, codes, [0.1, 0.2, 0.3], num_qubits=n,
                        rep_qubits=n)
    paulis.expec_pauli_sum_scan(x, codes, [1.0, -1.0, 0.5], num_qubits=n)
    q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
    h = tq.createPauliHamil(n, 3)
    tq.initPauliHamil(h, [1.0, -1.0, 0.5], codes)
    tq.applyTrotterCircuit(q, h, 0.2, 2, 1)
    tq.calcExpecPauliHamil(q, h)
    assert paulis.LAUNCHES == {"K3": 0, "K4": 0}


def test_qft_wrappers_on_cpu_take_the_plain_path_and_launch_nothing():
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()
    rng = np.random.default_rng(4)
    n = 15
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)).astype(np.float32))
    assert torch.equal(
        fused.apply_qft_multi_hi(x, num_qubits=n, t_hi=14, t_lo=14),
        fused.qft_multi_hi_plain(x, num_qubits=n, t_hi=14, t_lo=14))
    assert torch.equal(fused.apply_qft_cluster_multi(x, num_qubits=n),
                       fused.qft_cluster_multi_plain(x, num_qubits=n))
    for t, plain in ((14, fused.qft_ladder_plain),
                     (9, fused.qft_ladder_lo_plain)):
        assert torch.equal(
            fused.apply_qft_ladder_pallas(x, num_qubits=n, target=t),
            plain(x, num_qubits=n, target=t))
    assert torch.equal(bigstate.apply_sigma_swap(x, num_qubits=n,
                                                 group_bits=3),
                       bigstate.sigma_swap_plain(x, num_qubits=n,
                                                 group_bits=3))
    q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
    tq.applyFullQFT(q)
    tq.applyQFT(q, list(range(7, n)))
    assert C._fused_qft_multilayer(x, n, n).shape == x.shape
    assert all(v == 0 for v in fused.LAUNCHES.values())
    assert bigstate.LAUNCHES == {"K10": 0, "K10_bank": 0, "K10_rev": 0,
                                 "K10_rev_bank": 0}


def _one_op_of_each_kind(rng, n):
    """One op of every kind circuit.stats counts, as NumPy operands."""
    win = _op(rng, 7)
    eye2 = np.stack([np.eye(2), np.zeros((2, 2))])
    sides = rng.standard_normal((1, 2, 128, 128)) / 128
    return {
        "winfused": win,
        "megawin": ("megawin", (_op(rng, 7), _op(rng, 8))),
        "fused": ("fused", sides, sides.copy()),
        "swapfused": ("swapfused", 14, 9, 1, sides, sides.copy()),
        "apply": ("apply", (3,), eye2),
        "segswap": ("segswap", 14, 7, 1),
        "permute": ("permute", tuple(reversed(range(n)))),
        "xor": ("xor", (0, 14)),
        "gatherperm": ("gatherperm", (1, 2), (1, 0, 3, 2)),
        "sigma_swap": ("sigma_swap", 3),
        "sigma_rev": ("sigma_rev", 3),
    }


def test_sigma_swap_is_ported_and_qft_cu_is_built():
    """Every op kind circuit.stats counts executes (on the CPU, through
    the kernels' plain versions), and every kernel source is built."""
    rng = np.random.default_rng(8)
    n = 15
    ops = _one_op_of_each_kind(rng, n)
    counted = set(C.stats([])) - {"megawin_ops", "total_passes"}
    assert set(ops) == counted
    x = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    for kind, op in ops.items():
        y = C.execute_plan(x.clone(), [op], n)
        assert y.shape == x.shape and bool(torch.isfinite(y).all()), kind
        assert C.stats([op])[kind] == 1
    assert (build.CSRC / "qft.cu") in build.sources()
    assert {p.name for p in build.sources()} >= {"window.cu", "paulis.cu",
                                                  "qft.cu", "channels.cu"}


def test_channel_wrapper_and_density_drain_on_cpu_launch_nothing():
    fused.reset_launch_counts()
    rng = np.random.default_rng(6)
    nn = 16
    x = torch.from_numpy(rng.standard_normal((2, 1 << nn)).astype(np.float32))
    program = tuple(("depol", t, t + 8) for t in range(8))
    probs = [0.05] * 8
    assert torch.equal(
        fused.apply_pair_channel_sweep(x, program, probs, num_bits=nn),
        fused.pair_channel_sweep_plain(x, program, probs, num_bits=nn))
    rho = tq.createDensityQureg(8, tq.createQuESTEnv(device="cpu"))
    with tq.gateFusion(rho):
        for q in range(8):
            tq.mixDepolarising(rho, q, 0.05)
            tq.mixDamping(rho, q, 0.05)
    assert abs(tq.calcTotalProb(rho) - 1.0) < 1e-5
    assert fused.LAUNCHES["K5"] == 0


def test_channels_cu_is_built():
    assert (build.CSRC / "channels.cu") in build.sources()


def test_kernels_are_not_built_at_import():
    assert "lib" not in build._LIB
    assert "lib" not in fused._BOUND and "lib" not in paulis._BOUND
    assert "chan" not in fused._BOUND
    assert "lib" not in bigstate._BOUND


def test_other_devices_raise():
    x = torch.zeros((2, 1 << 14), device="meta")
    op = _op(np.random.default_rng(1), 7)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_window_stack(x, op[2], op[3], None, num_qubits=14, k=7)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_pair_channel_sweep(
            torch.zeros((2, 1 << 15), device="meta"), (("depol", 0, 14),),
            [0.1], num_bits=15)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_cluster_stack(x, op[2], op[3], num_qubits=14)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_swap_cluster_stack(
            torch.zeros((2, 1 << 15), device="meta"), op[2], op[3],
            num_qubits=15, h=14, b=7, m=1)


def test_execute_plan_dispatches_window_passes_through_the_wrappers(
        monkeypatch):
    calls = []
    real = fused.apply_window_stack

    def spy(*a, **kw):
        calls.append(kw["k"])
        return real(*a, **kw)

    monkeypatch.setattr(fused, "apply_window_stack", spy)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 1 << 15)))
    C.execute_plan(x, [_op(rng, 7), _op(rng, 8)], 15)
    assert calls == [7, 8]
