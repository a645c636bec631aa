"""The QFT slice of quest_tpu_torch against quest_tpu's, on the CPU.

* The ladder kernels' plain versions against the reference's Pallas
  kernels in interpret mode (as tests/test_qft_multilayer.py runs them),
  float32 on normalised states: qft_multi_hi_plain (K8) for k = 1..5 in
  both conj values, qft_cluster_multi_plain (K9), qft_ladder_plain (K6,
  t >= 14) and qft_ladder_lo_plain (K7, 7 <= t <= 13).  Limit 1e-6 max
  abs: the products are the same, but XLA's CPU code may round a
  multiply-add once where the port rounds twice.
* The elementwise ladder (kernels.apply_qft_ladder, the reference's form
  for float64 and the density bra twin) at float64, limit 1e-10.
* The routes: circuit._fused_qft_multilayer at radix 1..5 (float32, limit
  1e-6, and against numpy's FFT within 2e-6 as the reference's own test
  holds it), fused_qft's per-layer route (float64, 1e-10), and the plan of
  the QFT's dense lane gates.
* The API: applyQFT / applyFullQFT on state vectors and density
  registers, layered (5 qubits, subsets) and fused (14-16 state bits),
  against the reference (1e-10) and the DFT (1e-10); QASM records; the
  drain of pending fused gates; validation messages.
* The slice as a whole: bench.py config 3 cut to 15 qubits (two QFTs from
  |0...0>, amp_0 back at 1).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import oracle
import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import circuit as RC
from quest_tpu.models import circuits as RM
from quest_tpu.ops import fused as RF
from quest_tpu.ops import kernels as RK
from quest_tpu_torch import circuit as C
from quest_tpu_torch import precision
from quest_tpu_torch.models import circuits as TM
from quest_tpu_torch.ops import fused as F
from quest_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module's tests run (its
    spinning worker threads starve the other test processes)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


KTOL = 1e-6     # float32 plain versions against the reference kernels
TOL = 1e-10     # float64 routes and API


def _psi(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _soa(v, dt):
    return np.ascontiguousarray(np.stack([v.real, v.imag]).astype(dt))


def _both(x, fn_ref, fn_port):
    want = np.asarray(fn_ref(jnp.asarray(x))).reshape(2, -1)
    got = fn_port(torch.from_numpy(x.copy())).numpy().reshape(2, -1)
    return got, want


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,t_hi,t_lo", [(15, 14, 14), (16, 15, 14),
                                         (17, 16, 14), (17, 16, 16),
                                         (18, 17, 14), (19, 18, 14)],
                         ids=["k1", "k2", "k3", "k1_hi", "k4", "k5"])
@pytest.mark.parametrize("conj", [False, True])
def test_multi_hi_plain_matches_reference_kernel(n, t_hi, t_lo, conj):
    x = _soa(_psi(n, n + t_lo), np.float32)
    kw = dict(num_qubits=n, t_hi=t_hi, t_lo=t_lo, conj=conj)
    got, want = _both(x, lambda a: RF.apply_qft_multi_hi(a, interpret=True,
                                                         **kw),
                      lambda a: F.qft_multi_hi_plain(a, **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=KTOL)


@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("conj", [False, True])
def test_cluster_multi_plain_matches_reference_kernel(n, conj):
    x = _soa(_psi(n, 40 + n), np.float32)
    got, want = _both(
        x, lambda a: RF.apply_qft_cluster_multi(a, num_qubits=n, conj=conj,
                                                interpret=True),
        lambda a: F.qft_cluster_multi_plain(a, num_qubits=n, conj=conj))
    np.testing.assert_allclose(got, want, rtol=0, atol=KTOL)


@pytest.mark.parametrize("t", list(range(7, 16)))
@pytest.mark.parametrize("conj", [False, True])
def test_ladder_plain_matches_reference_kernel(t, conj):
    """t <= 13: K7's plain version; t >= 14: K6's (the CPU wrapper
    apply_qft_ladder_pallas picks the same one)."""
    n = 16
    x = _soa(_psi(n, t), np.float32)
    plain = F.qft_ladder_lo_plain if t < 14 else F.qft_ladder_plain
    got, want = _both(
        x, lambda a: RF.apply_qft_ladder_pallas(a, num_qubits=n, target=t,
                                                conj=conj, interpret=True),
        lambda a: plain(a, num_qubits=n, target=t, conj=conj))
    np.testing.assert_allclose(got, want, rtol=0, atol=KTOL)
    wrapped = F.apply_qft_ladder_pallas(torch.from_numpy(x), num_qubits=n,
                                        target=t, conj=conj)
    assert torch.equal(wrapped, torch.from_numpy(got.reshape(x.shape)))


def test_k6_plain_is_k8_with_one_layer_and_k7_one_layer_of_k9():
    """The kernels' sharing, on the plain versions: K9's pass is K7's
    layers 13..7 one after another, exactly."""
    n = 15
    x = torch.from_numpy(_soa(_psi(n, 5), np.float32))
    assert torch.equal(F.qft_ladder_plain(x, num_qubits=n, target=14),
                       F.qft_multi_hi_plain(x, num_qubits=n, t_hi=14,
                                            t_lo=14))
    y = x
    for t in range(13, 6, -1):
        y = F.qft_ladder_lo_plain(y, num_qubits=n, target=t)
    assert torch.equal(y, F.qft_cluster_multi_plain(x, num_qubits=n))


def test_multi_hi_plain_matches_per_layer_ladders():
    n = 17
    x = torch.from_numpy(_soa(_psi(n, 3), np.float32))
    y = x
    for t in range(16, 13, -1):
        y = F.qft_ladder_plain(y, num_qubits=n, target=t)
    z = F.qft_multi_hi_plain(x, num_qubits=n, t_hi=16, t_lo=14)
    assert float((y - z).abs().max()) < KTOL


@pytest.mark.parametrize("n,t,base", [(12, 4, 0), (12, 9, 0), (15, 11, 0),
                                      (16, 15, 0), (14, 12, 7), (16, 15, 8),
                                      (18, 17, 9)])
@pytest.mark.parametrize("conj", [False, True])
def test_elementwise_ladder_matches_reference(n, t, base, conj):
    x = _soa(_psi(n, 7 * t + base), np.float64)
    kw = dict(num_qubits=n, target=t, base=base, conj=conj)
    got, want = _both(x, lambda a: RK.apply_qft_ladder(a, **kw),
                      lambda a: K.apply_qft_ladder(a, **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_routing_rules_on_the_cpu():
    x32 = torch.zeros((2, 1 << 15), dtype=torch.float32)
    assert not F.qft_ladder_supported(x32, 15, 14, 0)
    assert not F.qft_multilayer_enabled(x32)
    meta = torch.zeros((2, 1 << 15), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        F.apply_qft_multi_hi(meta, num_qubits=15, t_hi=14, t_lo=14)
    with pytest.raises(ValueError, match="bad layer chunk"):
        F.apply_qft_multi_hi(x32, num_qubits=15, t_hi=14, t_lo=13)
    with pytest.raises(ValueError, match="t_top >= 13"):
        F.apply_qft_multilayer_ladders(x32, num_qubits=15, t_top=12)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,count,radix", [(15, 15, 1), (15, 15, 2),
                                           (16, 16, 3), (16, 16, 4),
                                           (17, 17, 5), (17, 15, 4)])
def test_multilayer_route_matches_reference(n, count, radix, monkeypatch):
    monkeypatch.setenv("QT_QFT_RADIX", str(radix))
    v = _psi(n, 100 + radix)
    x = _soa(v, np.float32)
    got, want = _both(
        x, lambda a: RC._fused_qft_multilayer(a, n, count, True),
        lambda a: C._fused_qft_multilayer(a, n, count, radix=radix))
    np.testing.assert_allclose(got, want, rtol=0, atol=KTOL)
    fft = np.fft.ifft(v.reshape(1 << (n - count), 1 << count), axis=1,
                      norm="ortho").reshape(-1)
    assert np.abs(got[0] + 1j * got[1] - fft).max() < 2e-6


@pytest.mark.parametrize("n,start,count,shifts", [
    (14, 0, 14, (0,)), (16, 0, 12, (0,)), (16, 7, 9, (0,)),
    (17, 8, 9, (0,)), (16, 0, 8, (0, 8)), (14, 0, 7, (0, 7))])
def test_per_layer_route_matches_reference(n, start, count, shifts):
    x = _soa(_psi(n, n + start + count), np.float64)
    got, want = _both(
        x, lambda a: RC.fused_qft(a, n, start, count, shifts=shifts),
        lambda a: C.fused_qft(a, n, start, count, shifts=shifts))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("conj", [False, True])
def test_lane_layer_plan_matches_reference(conj):
    """The multilayer route's dense lane gates (with the two rev7 folds)
    plan to the same passes in both packages."""
    n, dt = 16, np.float32
    gates = [C.Gate(tuple(range(qq + 1)), C._qft_layer_dense(qq, conj, dt))
             for qq in range(6, -1, -1)]
    rev7 = C._rev_perm_mat(7, dt)
    gates += [C.Gate(tuple(range(7)), rev7), C.Gate(tuple(range(7, 14)),
                                                    rev7)]
    rgates = [RC.Gate(g.targets, g.mat) for g in gates]
    np.testing.assert_array_equal(rev7, RC._rev_perm_mat(7, dt))
    for qq in range(7):
        np.testing.assert_array_equal(C._qft_layer_dense(qq, conj, dt),
                                      RC._qft_layer_dense(qq, conj, dt))
    got = C.plan_circuit(gates, n)
    want = RC.plan_circuit(rgates, n)
    assert [op[0] for op in got] == [op[0] for op in want]
    for a, b in zip(got, want):
        assert a[1] == b[1] and tuple(a[4:6]) == tuple(b[4:6])
        for x, y in zip(a[2:4], b[2:4]):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=0, atol=1e-6)


def test_config3_cut_to_15_qubits():
    """bench.py config 3 (bench.py:238-258) at 15 qubits, float32: two QFTs
    from |0...0> on the canonical view; amp_0 returns to 1, and the state
    equals the reference's route's."""
    n = 15
    a = TM.zero_state_canonical(n, torch.float32, "cpu")
    ra = RM.zero_state_canonical(n)
    for _ in range(2):
        a = C.fused_qft(a, n, 0, n)
        ra = RC.fused_qft(ra, n, 0, n)
    assert a.shape == (2, 2, 128, 128)
    assert abs(float(TM.amp00_canonical(a)) - 1.0) < 1e-5
    assert abs(float(TM.amp00_canonical(a))
               - float(RM.amp00_canonical(ra))) < 1e-6
    np.testing.assert_allclose(a.numpy().reshape(2, -1),
                               np.asarray(ra).reshape(2, -1), rtol=0,
                               atol=KTOL)


# ---------------------------------------------------------------------------
# The API
# ---------------------------------------------------------------------------


@pytest.fixture
def double():
    old = precision.get_precision()
    tq.set_precision(2)
    yield
    tq.set_precision(old)


@functools.lru_cache(maxsize=None)
def _ref_env():
    return qt.createQuESTEnv(num_devices=1)


def _pair(n, density, seed):
    """(port register, reference register, oracle array) with the same
    random state (a random mixed state for a density register)."""
    rng = np.random.default_rng(seed)
    if density:
        arr = oracle.random_density(n, rng)
        flat = arr.T.ravel()
        q = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"))
        r = qt.createDensityQureg(n, _ref_env())
    else:
        arr = oracle.random_state(n, rng)
        flat = arr
        q = tq.createQureg(n, tq.createQuESTEnv(device="cpu"))
        r = qt.createQureg(n, _ref_env())
    q.amps = torch.from_numpy(np.stack([flat.real, flat.imag]).copy())
    oracle.set_qureg_from_array(qt, r, arr)
    return q, r, arr


def _dense(q):
    a = q.amps.numpy()
    flat = a[0] + 1j * a[1]
    if q.is_density_matrix:
        dim = 1 << q.num_qubits_represented
        return flat.reshape(dim, dim).T
    return flat


def _dft_on(arr, n, qubits, density):
    """The QFT of ``qubits`` (qubits[0] least significant) by numpy's FFT:
    the DFT amp_y = 2^{-m/2} sum_x e^{2 pi i x y / 2^m} amp_x is the
    orthonormal inverse FFT along the register's axis."""
    m = len(qubits)
    order = [q for q in range(n) if q not in qubits] + list(qubits)

    def on_axis(v):
        # axis of qubit q in reshape(2, ..., 2) is n - 1 - q; gather the
        # register's axes last, most significant first
        t = v.reshape((2,) * n).transpose([n - 1 - q for q in order[:-m]]
                                          + [n - 1 - q for q in qubits[::-1]])
        shape = t.shape
        t = np.fft.ifft(t.reshape(-1, 1 << m), axis=1, norm="ortho")
        t = t.reshape(shape)
        inv = np.argsort([n - 1 - q for q in order[:-m]]
                         + [n - 1 - q for q in qubits[::-1]])
        return t.transpose(inv).reshape(-1)

    if not density:
        return on_axis(arr)
    rows = np.stack([on_axis(col) for col in arr.T]).T      # F rho
    return np.stack([on_axis(row.conj()).conj() for row in rows])  # F rho F+


_API_CASES = [
    ("layered_full", 5, False, None),
    ("layered_subset", 5, False, [1, 3]),
    ("layered_subset_desc", 6, False, [4, 2, 0]),
    ("layered_rho_full", 5, True, None),
    ("layered_rho_subset", 5, True, [3, 0, 2]),
    ("layered_offset_run", 14, False, [2, 3, 4, 5]),
    ("fused_full", 14, False, None),
    ("fused_full_16", 16, False, None),
    ("fused_low_run", 15, False, list(range(0, 9))),
    ("fused_high_run", 16, False, list(range(7, 16))),
    ("fused_rho_full", 7, True, None),
    ("fused_rho_full_16", 8, True, None),
    ("fused_rho_high_run", 8, True, list(range(7, 8))),
]


@pytest.mark.parametrize("label,n,density,qubits", _API_CASES,
                         ids=[c[0] for c in _API_CASES])
def test_qft_api_matches_reference_and_dft(double, label, n, density, qubits):
    q, r, arr = _pair(n, density, seed=len(label) + n)
    if qubits is None:
        tq.applyFullQFT(q)
        qt.applyFullQFT(r)
        qubits = list(range(n))
    else:
        tq.applyQFT(q, qubits)
        qt.applyQFT(r, qubits)
    got = _dense(q)
    np.testing.assert_allclose(got, oracle.state_from_qureg(r), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got, _dft_on(arr, n, qubits, density),
                               rtol=0, atol=TOL)


def test_qft_api_small_matches_dft_matrix(double):
    """At 5 qubits against the reference suite's own oracle matrix
    (tests/oracle.py dft_matrix), on a state and a density register."""
    q, _r, vec = _pair(5, False, seed=11)
    tq.applyFullQFT(q)
    np.testing.assert_allclose(_dense(q), oracle.dft_matrix(5) @ vec,
                               rtol=0, atol=TOL)
    rho, _r, mat = _pair(5, True, seed=12)
    tq.applyFullQFT(rho)
    f = oracle.dft_matrix(5)
    np.testing.assert_allclose(_dense(rho), f @ mat @ f.conj().T, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("n,qubits", [(5, [4, 1, 2]), (14, None),
                                      (15, list(range(7, 12)))])
def test_qft_qasm_matches_reference(double, n, qubits):
    q, r, _ = _pair(n, False, seed=3)
    tq.startRecordingQASM(q)
    qt.startRecordingQASM(r)
    if qubits is None:
        tq.applyFullQFT(q)
        qt.applyFullQFT(r)
    else:
        tq.applyQFT(q, qubits)
        qt.applyQFT(r, qubits)
    assert q.qasm_log.lines == r.qasm_log.lines
    assert any("controlled-phase ladder" in ln for ln in q.qasm_log.lines)


@pytest.mark.parametrize("n", [5, 14])
def test_qft_inside_gate_fusion_drains_first(double, n):
    """Gates pending in a gateFusion buffer apply before the QFT, as in the
    reference: the result equals the reference's under its own fusion."""
    q, r, _ = _pair(n, False, seed=9)
    for m, reg in ((tq, q), (qt, r)):
        with m.gateFusion(reg):
            m.hadamard(reg, 0)
            m.rotateY(reg, n - 1, 0.3)
            m.controlledNot(reg, 0, 1)
            m.applyFullQFT(reg)
            m.rotateX(reg, 2, -0.7)
    np.testing.assert_allclose(_dense(q), oracle.state_from_qureg(r),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("qubits", [[0, 0], [5], [], [1, -1]])
def test_qft_validation_messages_match_reference(qubits):
    q = tq.createQureg(5, tq.createQuESTEnv(device="cpu"))
    r = qt.createQureg(5, _ref_env())
    with pytest.raises(qt.QuESTError) as want:
        qt.applyQFT(r, qubits)
    with pytest.raises(tq.QuESTError) as got:
        tq.applyQFT(q, qubits)
    assert str(got.value) == str(want.value)
