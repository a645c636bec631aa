"""K12's and K10's bank forms (the reference's jax.vmap of
_apply_swap_cluster_stack_jit and _sigma_swap_jit), on the CPU.

* ``circuit.execute_plan`` on a (B, 2, 2^n) bank sends each ``swapfused``
  and ``sigma_swap`` op to ONE wrapper call for the whole bank (counted
  with a monkeypatch), and every element equals its own scalar
  ``execute_plan`` bit for bit, with sides shared and per element, at
  float64 and float32.
* The bank plain versions equal the per-element plain results.
* The changed ctypes signatures of ``qt_swap_cluster_stack_f32/_f64`` and
  ``qt_sigma_swap_f32`` match csrc/window.cu and csrc/qft.cu.
* ``apply_sigma_swap`` refuses a bank whose grid would pass the z limit,
  before any launch; a bank on a device without kernels is refused.
* The launch counters have the new keys, and CPU banks launch nothing.
The kernels themselves run on the card only (chip_smoke.py,
bank_forms_parity and bank_forms_main).
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from quest_tpu_torch import circuit as C
from quest_tpu_torch.ops import bigstate, fused

torch.set_num_threads(1)

CSRC = pathlib.Path(fused.__file__).parent.parent / "csrc"
N = 16
NB = 3


def _sides(rng, rank, nb=None):
    shape = ((nb,) if nb else ()) + (rank, 2, 128, 128)
    return rng.standard_normal(shape) / 128


def _bank(rng, n, nb, dtype):
    x = rng.standard_normal((nb, 2, 1 << n))
    x /= np.sqrt((x ** 2).sum(axis=(1, 2), keepdims=True))
    return torch.as_tensor(x, dtype=dtype)


def _plan(rng, per, dtype):
    """A bank plan holding a cluster pass, a swap + cluster pass and a
    sigma swap: per-element sides carry a leading B axis."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    nb = NB if per else None
    sa, sb = (_sides(rng, 1, nb).astype(np_dt) for _ in range(2))
    fa, fb = (_sides(rng, 2, nb).astype(np_dt) for _ in range(2))
    return [("fused", fa, fb), ("swapfused", 14, 7, 2, sa, sb),
            ("sigma_swap", 4), ("swapfused", 15, 9, 1, sa, sb)]


@pytest.fixture
def counted(monkeypatch):
    """Calls of the K12 and K10 wrappers, by whether they got a bank."""
    calls = {"K12": [], "K10": []}
    real12, real10 = fused.apply_swap_cluster_stack, \
        bigstate.apply_sigma_swap

    def k12(amps, *a, **k):
        calls["K12"].append(fused.bank_size(amps, k["num_qubits"]))
        return real12(amps, *a, **k)

    def k10(amps, *a, **k):
        calls["K10"].append(fused.bank_size(amps, k["num_qubits"]))
        return real10(amps, *a, **k)

    monkeypatch.setattr(fused, "apply_swap_cluster_stack", k12)
    monkeypatch.setattr(bigstate, "apply_sigma_swap", k10)
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per", [False, True], ids=["shared", "per_element"])
def test_execute_plan_runs_the_bank_forms_once_per_op(counted, dtype, per):
    rng = np.random.default_rng(31 + per)
    ops = _plan(rng, per, dtype)
    bank = _bank(rng, N, NB, dtype)
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()
    out = C.execute_plan(bank, ops, N)
    # one wrapper call per op, each for the whole bank
    assert counted == {"K12": [NB, NB], "K10": [NB]}
    for b in range(NB):
        want = C.execute_plan(bank[b], [fused.bank_element_op(op, b)
                                        for op in ops], N)
        assert torch.equal(out[b], want), b
    assert out.shape == bank.shape and out.dtype == dtype
    # on the CPU nothing launches
    assert not any(fused.LAUNCHES.values())
    assert not any(bigstate.LAUNCHES.values())


@pytest.mark.parametrize("per", [False, True], ids=["shared", "per_element"])
def test_swap_cluster_bank_plain_is_the_elements_plain(per):
    rng = np.random.default_rng(5)
    a, b = _sides(rng, 1, NB if per else None), \
        _sides(rng, 1, NB if per else None)
    bank = _bank(rng, N, NB, torch.float64)
    got = fused.apply_swap_cluster_stack(bank, a, b, num_qubits=N, h=14,
                                         b=8, m=2)
    for e in range(NB):
        ea, eb = (a[e], b[e]) if per else (a, b)
        assert torch.equal(got[e], fused.swap_cluster_stack_plain(
            bank[e], ea, eb, num_qubits=N, h=14, b=8, m=2))


def test_sigma_swap_bank_plain_is_the_elements_plain():
    rng = np.random.default_rng(6)
    n, g = 13, 3
    bank = _bank(rng, n, NB, torch.float32)
    got = bigstate.apply_sigma_swap(bank, num_qubits=n, group_bits=g)
    assert torch.equal(got, bigstate.sigma_swap_plain(bank, num_qubits=n,
                                                      group_bits=g))
    for e in range(NB):
        assert torch.equal(got[e], bigstate.sigma_swap_plain(
            bank[e], num_qubits=n, group_bits=g))
    # an involution, element by element
    assert torch.equal(bigstate.apply_sigma_swap(got, num_qubits=n,
                                                 group_bits=g), bank)


def _declared(src, name, qtpass):
    m = re.search(rf"int {name}\(([^)]*)\)", src)
    assert m, name
    want = []
    for p in (" ".join(q.split()) for q in m.group(1).split(",")):
        if p.startswith("const QtPass*"):
            want.append(ctypes.POINTER(qtpass))
        elif "*" in p:
            want.append(ctypes.c_void_p)
        else:
            assert p.startswith("int "), p
            want.append(ctypes.c_int)
    return want


@pytest.mark.parametrize("name", ["qt_swap_cluster_stack_f32",
                                  "qt_swap_cluster_stack_f64"])
def test_swap_cluster_entry_signature_matches_the_source(name):
    """One register and a bank share K12's entry: K1's (a bank count, the
    elements' passes on the host and on the card), then h, b and m."""
    src = (CSRC / "window.cu").read_text()
    assert list(fused.SWAP_CLUSTER_ARGTYPES) == _declared(src, name,
                                                          fused._QtPass)


def test_sigma_entry_signature_matches_the_source():
    src = (CSRC / "qft.cu").read_text()
    assert list(bigstate.SIGMA_ARGTYPES) == _declared(
        src, "qt_sigma_swap_f32", None)
    assert "int nbank" in re.search(r"int qt_sigma_swap_f32\(([^)]*)\)",
                                    src).group(1)


def test_sigma_swap_refuses_a_grid_over_the_z_limit():
    n, g = 17, 1                     # 2^(17 - 4) = 8192 blocks a register
    assert bigstate.SIGMA_GRID_Z_MAX == 65535
    bigstate.check_sigma_grid(n, g, 7)
    with pytest.raises(ValueError, match="grid z limit of 65535"):
        bigstate.check_sigma_grid(n, g, 8)
    with pytest.raises(ValueError, match="grid z limit"):
        bigstate.check_sigma_grid(20, 1, 0)    # one register of 2^16
    bigstate.reset_launch_counts()
    for device in ("cpu", "meta"):
        bank = torch.zeros((8, 2, 1 << n), device=device)
        with pytest.raises(ValueError, match="grid z limit"):
            bigstate.apply_sigma_swap(bank, num_qubits=n, group_bits=g)
    assert not any(bigstate.LAUNCHES.values())
    ok = bigstate.apply_sigma_swap(torch.zeros((7, 2, 1 << n)),
                                   num_qubits=n, group_bits=g)
    assert ok.shape == (7, 2, 1 << n)


def test_bank_forms_refuse_a_device_without_kernels():
    rng = np.random.default_rng(8)
    bank = torch.zeros((2, 2, 1 << N), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused.apply_swap_cluster_stack(bank, _sides(rng, 1), _sides(rng, 1),
                                       num_qubits=N, h=14, b=7, m=2)
    with pytest.raises(RuntimeError, match="no kernel"):
        bigstate.apply_sigma_swap(bank, num_qubits=N, group_bits=4)
    with pytest.raises(ValueError, match=r"\(B, 2, 2\^16\)"):
        bigstate.apply_sigma_swap(torch.zeros((2, 3, 1 << N)), num_qubits=N,
                                  group_bits=4)


def test_launch_keys():
    assert {"K12", "K12_bank", "K11_bank"} <= set(fused.LAUNCHES)
    assert set(bigstate.LAUNCHES) == {"K10", "K10_bank", "K10_rev",
                                      "K10_rev_bank"}
    fused.LAUNCHES["K12_bank"] = 3
    bigstate.LAUNCHES["K10_bank"] = 2
    bigstate.LAUNCHES["K10_rev_bank"] = 1
    fused.reset_launch_counts()
    bigstate.reset_launch_counts()
    assert fused.LAUNCHES["K12_bank"] == 0
    assert bigstate.LAUNCHES == {"K10": 0, "K10_bank": 0, "K10_rev": 0,
                                 "K10_rev_bank": 0}


@pytest.mark.parametrize("entry", ["qt_sigma_swap_f32", "qt_sigma_rev_f32"])
def test_k10_entries_share_the_signature(entry):
    """Both K10 entries (sigma and the reversal form) take the state, n,
    g, the pair tables, their length, the bank size and the stream."""
    src = (CSRC / "qft.cu").read_text()
    assert list(bigstate.SIGMA_ARGTYPES) == _declared(src, entry, None)


def test_bit_reversal_refuses_what_sigma_refuses():
    """The reversal form's wrapper refuses a grid over the z limit before
    any launch, a device without kernels and a state of the wrong shape,
    naming itself."""
    n, g = 17, 1
    bigstate.reset_launch_counts()
    for device in ("cpu", "meta"):
        bank = torch.zeros((8, 2, 1 << n), device=device)
        with pytest.raises(ValueError, match="apply_bit_reversal: .*grid z "
                                             "limit of 65535"):
            bigstate.apply_bit_reversal(bank, num_qubits=n, group_bits=g)
    assert not any(bigstate.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="apply_bit_reversal: no kernel"):
        bigstate.apply_bit_reversal(torch.zeros((2, 2, 1 << N),
                                                device="meta"),
                                    num_qubits=N, group_bits=4)
    with pytest.raises(ValueError, match=r"\(B, 2, 2\^16\)"):
        bigstate.apply_bit_reversal(torch.zeros((2, 3, 1 << N)),
                                    num_qubits=N, group_bits=4)
    with pytest.raises(ValueError, match="4\\*group_bits"):
        bigstate.apply_bit_reversal(torch.zeros((2, 1 << N)), num_qubits=N,
                                    group_bits=5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_execute_plan_runs_the_reversal_bank_form_once(monkeypatch, dtype):
    """A sigma_rev op on a bank is one wrapper call for the whole bank,
    and each element equals its own scalar execute_plan."""
    calls = []
    real = bigstate.apply_bit_reversal

    def k10r(amps, *a, **k):
        calls.append(fused.bank_size(amps, k["num_qubits"]))
        return real(amps, *a, **k)

    monkeypatch.setattr(bigstate, "apply_bit_reversal", k10r)
    bank = _bank(np.random.default_rng(9), N, NB, dtype)
    out = C.execute_plan(bank, [("sigma_rev", 4)], N)
    assert calls == [NB]
    for b in range(NB):
        assert torch.equal(out[b], C.execute_plan(bank[b],
                                                  [("sigma_rev", 4)], N))
