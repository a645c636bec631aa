"""Staged window passes (fused.stage_ops, fusion._program_stage).

A drain of a plan the memory tier holds feeds its window passes from
operands made once and kept in one host block: the side images, masks and
TF32 splits a launch would make.  On the CPU the builders run as on the
card (``_pass_struct`` / ``_bank_descs`` work on any device): a stage's
bytes are held to ``_side_image`` bit for bit, and the drains' bookkeeping
(built at a plan's second drain, reused, dropped with the plan, refused
over the byte cap, found per op under a governor split) is exercised with
the CPU admitted to staging.  The tests marked ``card`` drain on the card
and hold the staged states to the built path's bit for bit; without a
card they skip (on the card: ``python -m pytest --noconftest -m card
tests/test_torch_staging.py``).
"""

import time
import weakref

import numpy as np
import pytest
import torch

import quest_tpu_torch as tq
from quest_tpu_torch import fusion
from quest_tpu_torch import governor as G
from quest_tpu_torch import precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import telemetry as T
from quest_tpu_torch.ops import fused

MODES = {
    # case: (dtype, precision mode, sides exact in TF32)
    "highest-x3": (torch.float32, "highest", False),
    "highest-exact": (torch.float32, "highest", True),
    "default": (torch.float32, "default", False),
    "bf16_3x": (torch.float32, "bf16_3x", False),
    "float64": (torch.float64, "highest", False),
}


def _sides(rng, rank, exact, lead=()):
    """A side stack (..., R, 2, 128, 128): random, or exact in TF32 (a
    permutation matrix)."""
    if exact:
        m = np.zeros(lead + (rank, 2, 128, 128))
        m[..., 0, :, :] = np.eye(128)[rng.permutation(128)]
        return m
    return rng.standard_normal(lead + (rank, 2, 128, 128)) / 128


def _raw(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _at(sp, off, t):
    return sp.host[off:off + _raw(t).numel()]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("case", sorted(MODES))
def test_a_staged_register_pass_holds_the_launch_images(case, masked):
    """A register's staged pass: one descriptor, its split the launch's,
    its side images ``_side_image``'s and its mask the uploaded mask, bit
    for bit."""
    dtype, mode, exact = MODES[case]
    rng = np.random.default_rng(3)
    a, b = _sides(rng, 2, exact), _sides(rng, 2, exact)
    mask = rng.standard_normal((2, 128, 128)) if masked else None
    op = ("winfused", 8, a, b, True, True, mask)
    x = torch.zeros((2, 1 << 15), dtype=dtype)
    sp = fused.stage_pass(op, x, 15, mode)
    split = fused.pass_split(dtype, mode, a, b)
    if case == "highest-exact":
        assert split == fused.SPLIT_EXACT
    assert not sp.per_element and len(sp.fields) == 1
    k, rank, apply_a, apply_b, got, oa, ob, om = sp.fields[0]
    assert (k, rank, apply_a, apply_b, got) == (8, 2, 1, 1, split)
    for off, side in ((oa, a), (ob, b)):
        img = fused._side_image(side, dtype, x.device, split)
        assert off % 256 == 0
        assert torch.equal(_at(sp, off, img), _raw(img))
    if masked:
        m = fused._as_operand(mask, x)
        assert torch.equal(_at(sp, om, m), _raw(m))
    else:
        assert om == -1


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("case", sorted(MODES))
def test_a_staged_bank_pass_holds_each_elements_images(case, masked):
    """A bank pass with a per-element A stack (element 0 exact in TF32,
    so "highest" gives the elements different splits), a shared B stack
    and a per-element mask: each element's descriptor holds its own split
    and the images ``_side_image`` makes for it."""
    dtype, mode, exact = MODES[case]
    rng = np.random.default_rng(4)
    nb = 3
    a = _sides(rng, 1, exact, (nb,))
    a[0] = _sides(rng, 1, True)
    b = _sides(rng, 1, exact)
    mask = rng.standard_normal((nb, 2, 128, 128)) if masked else None
    op = ("winfused", 7, a, b, True, False, mask)
    bank = torch.zeros((nb, 2, 1 << 14), dtype=dtype)
    sp = fused.stage_pass(op, bank, 14, mode)
    splits = fused.bank_pass_splits(dtype, mode, nb, a)
    assert sp.per_element and len(sp.fields) == nb
    if case == "highest-x3":
        assert splits[0] != splits[1]
    m = fused._as_operand(mask, bank) if masked else None
    for e, (k, rank, apply_a, apply_b, split, oa, ob, om) in enumerate(
            sp.fields):
        assert (k, rank, apply_a, apply_b, split) == (7, 1, 1, 0, splits[e])
        img_a = fused._side_image(a, dtype, bank.device, split, elem=e)
        img_b = fused._side_image(b, dtype, bank.device, split)
        assert torch.equal(_at(sp, oa, img_a), _raw(img_a))
        assert torch.equal(_at(sp, ob, img_b), _raw(img_b))
        if masked:
            assert torch.equal(_at(sp, om, m[e]), _raw(m[e]))
        else:
            assert om == -1


@pytest.mark.parametrize("kind", ["fused", "swapfused"])
def test_cluster_passes_stage_k1s_pass_at_seven(kind):
    """K11's and K12's passes stage the dual-sided unmasked pass at k = 7
    their launches run."""
    rng = np.random.default_rng(5)
    a, b = _sides(rng, 2, False), _sides(rng, 2, False)
    op = ("fused", a, b) if kind == "fused" else ("swapfused", 14, 7, 2, a, b)
    x = torch.zeros((2, 1 << 16), dtype=torch.float32)
    sp = fused.stage_pass(op, x, 16, "highest")
    want = fused.stage_pass(("winfused", 7, a, b, True, True), x, 16,
                            "highest")
    assert sp.fields == want.fields
    assert torch.equal(sp.host, want.host)


def test_stage_ops_packs_the_stageable_passes_into_one_block():
    """One block for the program's window passes with host arrays, each on
    256 bytes and apart from the others; an op that appears twice is
    staged once; tensor operands, megawin groups and permutations are
    left to their own paths; over the limit nothing is staged."""
    rng = np.random.default_rng(6)
    x = torch.zeros((2, 1 << 15), dtype=torch.float32)
    w1 = ("winfused", 8, _sides(rng, 1, False), _sides(rng, 1, False),
          True, True, rng.standard_normal((2, 128, 128)))
    w2 = ("winfused", 7, _sides(rng, 3, False), _sides(rng, 3, False),
          False, True, None)
    cl = ("fused", _sides(rng, 1, False), _sides(rng, 1, False))
    on_device = ("winfused", 7, torch.as_tensor(w2[2]),
                 torch.as_tensor(w2[3]), True, True, None)
    mega = ("megawin", (w1, w2))
    ops = [w1, ("gatherperm", (0, 1), (1, 0)), w2, w1, on_device, mega, cl]
    assert [fused.stageable(op) for op in ops] == [
        True, False, True, True, False, False, True]
    block, staged = fused.stage_ops(ops, x, 15, "highest", 1 << 30)
    assert set(staged) == {id(w1), id(w2), id(cl)}
    spans = []
    for op in (w1, w2, cl):
        sp = staged[id(op)]
        start = sp.host.data_ptr() - block.data_ptr()
        assert sp.host.untyped_storage().data_ptr() == \
            block.untyped_storage().data_ptr()
        assert start % 256 == 0
        spans.append((start, start + sp.host.numel()))
        alone = fused.stage_pass(op, x, 15, "highest")
        assert sp.fields == alone.fields
        assert torch.equal(sp.host, alone.host)
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))
    assert block.numel() == spans[-1][1]
    assert fused.stage_ops(ops, x, 15, "highest", block.numel() - 1) is None


# ---------------------------------------------------------------------------
# Drains
# ---------------------------------------------------------------------------

N = 14
DEPTH = 3


def _haar(rng, count):
    z = (rng.standard_normal((count, 2, 2))
         + 1j * rng.standard_normal((count, 2, 2))) / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None, :]


def _layers(q, us, n, depth, apply):
    for d in range(depth):
        for t in range(n):
            apply(q, t, us[d * n + t])
        for t in range(d % 2, n - 1, 2):
            tq.controlledNot(q, t, t + 1)


def _circuit(q, us, n=N, depth=DEPTH):
    """A drain of an rc26-style circuit (layers of one-qubit unitaries and
    CNOT ladders) from |0>, and the state it leaves."""
    tq.initZeroState(q)
    with tq.gateFusion(q):
        _layers(q, us, n, depth, tq.unitary)
        tq.calcProbOfOutcome(q, n - 1, 0)
    return q.amps.clone()


def _bank_circuit(q, us, n=N, depth=DEPTH):
    """The same on a bank: each element its own unitaries (``us`` of
    shape (count, B, 2, 2)), the CNOTs shared."""
    tq.initZeroState(q)
    with tq.gateFusion(q):
        _layers(q, us, n, depth,
                lambda q, t, u: tq.applyBatchedUnitary(q, (t,), u))
        tq.calcExpecPauliSumBatched(q, [[0] * (n - 1) + [3]], [1.0])
    return q.amps.clone()


def _staged_total(source):
    return T.counter_sum("fusion_staged_passes_total", source=source)


def _dispatches(since):
    return [r["attrs"] for r in T.spans(since)
            if r["name"] == "fusion.dispatch"]


def _one_slot():
    """{(device, dtype, mode): entry} of the one plan that has stages."""
    (slot,) = fusion._stages.values()
    return slot


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.fixture
def staging(monkeypatch):
    """The CPU admitted to staging, telemetry on, float32 registers, an
    empty memory tier and no budget; ``fused.stage_ops`` counted."""
    monkeypatch.setattr(fusion, "_STAGE_DEVICES", ("cuda", "cpu"))
    for var in ("QT_HBM_BUDGET_BYTES", "QT_MEM_POLICY"):
        monkeypatch.delenv(var, raising=False)
    count = _Counting(fused.stage_ops)
    monkeypatch.setattr(fused, "stage_ops", count)
    old, mode = precision.get_precision(), T.mode_name()
    tq.set_precision(1)
    T.configure("on")
    fusion.clear_plan_caches()
    G.reset()
    degr = dict(PR.DEGRADATIONS)
    yield count
    fusion.clear_plan_caches()
    G.reset()
    PR.DEGRADATIONS.clear()
    PR.DEGRADATIONS.update(degr)
    T.configure(mode)
    tq.set_precision(old)
    fused.set_matmul_precision("highest")


@pytest.fixture(scope="module")
def cpu_env():
    return tq.createQuESTEnv(device="cpu")


def _split_budget(q, program):
    """A budget under which the governor splits ``program`` into dispatch
    groups: the states' peak and 60 % of its pass arrays."""
    state = G.register_bytes_per_device(q)
    arrays = sum(G._part_array_bytes(p) for p in program)
    return G._program_peak(program, state, 0, 1) + int(0.6 * arrays)


def _passes(program):
    return fusion._window_passes(program, None)[0]


def test_a_plan_is_staged_at_its_second_drain_and_reused(staging, cpu_env):
    """The first drain of a plan builds its passes (the plan is marked
    seen), the second stages them, later drains reuse that stage: one
    build, the same block, every pass counted as staged and the
    dispatch span's ``staged`` attr the group's window passes."""
    q = tq.createQureg(N, cpu_env)
    us = _haar(np.random.default_rng(7), N * DEPTH)
    stage0, built0 = _staged_total("stage"), _staged_total("built")
    t0 = time.time_ns()
    outs, builds, blocks = [], [], []
    for _ in range(4):
        outs.append(_circuit(q, us))
        builds.append(staging.calls)
        slot = _one_slot()
        (sub, entry), = slot.items()
        blocks.append(entry if isinstance(entry, str) else entry.block)
    assert builds == [0, 1, 1, 1]
    assert blocks[0] == fusion._SEEN
    assert blocks[1] is blocks[2] is blocks[3]
    assert sub == ("cpu", torch.float32, "highest")
    program = entry.program
    passes = _passes(program)
    assert passes > 0 and len(entry.passes) == passes
    assert _staged_total("built") - built0 == passes
    assert _staged_total("stage") - stage0 == 3 * passes
    assert [d["staged"] for d in _dispatches(t0)] == [0] + [passes] * 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_each_dtype_and_mode_has_its_own_stage(staging, cpu_env):
    """A plan drained on a float32 and a float64 register is staged for
    each (their images differ); another precision mode is another plan
    (the mode is in the plan key) with its own splits."""
    us = _haar(np.random.default_rng(8), N * DEPTH)
    q32 = tq.createQureg(N, cpu_env)
    tq.set_precision(2)
    q64 = tq.createQureg(N, cpu_env)
    tq.set_precision(1)
    for q in (q32, q64):
        for _ in range(2):
            _circuit(q, us)
    slot = _one_slot()
    assert set(slot) == {("cpu", torch.float32, "highest"),
                         ("cpu", torch.float64, "highest")}
    splits = {sub: {f[4] for sp in st.passes.values() for f in sp.fields}
              for sub, st in slot.items()}
    assert splits == {("cpu", torch.float32, "highest"): {fused.SPLIT_TF32X3},
                      ("cpu", torch.float64, "highest"): {fused.SPLIT_EXACT}}
    fused.set_matmul_precision("bf16_3x")
    for _ in range(2):
        _circuit(q32, us)
    assert len(fusion._stages) == 2 and staging.calls == 3
    (bf,) = [s[("cpu", torch.float32, "bf16_3x")]
             for s in fusion._stages.values()
             if ("cpu", torch.float32, "bf16_3x") in s]
    assert {f[4] for sp in bf.passes.values() for f in sp.fields} == {
        fused.SPLIT_BF16X3}


def test_a_stage_leaves_with_its_plan(staging, cpu_env, monkeypatch):
    """A plan evicted from the memory tier takes its stages with it, and
    ``clear_plan_caches`` drops them all."""
    monkeypatch.setattr(fusion, "_PLAN_CACHE_MAX", 1)
    q = tq.createQureg(N, cpu_env)
    rng = np.random.default_rng(9)
    first, second = _haar(rng, N * DEPTH), _haar(rng, N * DEPTH)
    for _ in range(2):
        _circuit(q, first)
    (key,) = fusion._stages
    assert isinstance(fusion._stages[key][("cpu", torch.float32, "highest")],
                      fusion._Stage)
    _circuit(q, second)
    assert key not in fusion._plan_cache and key not in fusion._stages
    _circuit(q, second)
    assert len(fusion._stages) == 1 and staging.calls == 2
    fusion.clear_plan_caches()
    assert fusion._stages == {}


def test_a_program_over_the_byte_cap_is_not_staged(staging, cpu_env,
                                                   monkeypatch):
    """A program whose operands would pass the cap is refused once and
    runs the built path on every drain, its passes counted as built."""
    monkeypatch.setattr(fusion, "_STAGE_MAX_BYTES", 1 << 10)
    q = tq.createQureg(N, cpu_env)
    us = _haar(np.random.default_rng(10), N * DEPTH)
    stage0, built0 = _staged_total("stage"), _staged_total("built")
    outs = [_circuit(q, us) for _ in range(3)]
    (entry,) = _one_slot().values()
    assert entry == fusion._OVER and staging.calls == 1
    passes = _passes(next(iter(fusion._plan_cache.values())))
    assert _staged_total("stage") == stage0
    assert _staged_total("built") - built0 == 3 * passes
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_older_stages_leave_to_make_room(staging, cpu_env, monkeypatch):
    """With room for one program's stage, staging a second plan returns
    the first to its seen state, to be staged again at its next drain."""
    q = tq.createQureg(N, cpu_env)
    rng = np.random.default_rng(11)
    first, second = _haar(rng, N * DEPTH), _haar(rng, N * DEPTH)
    for _ in range(2):
        _circuit(q, first)
    (key,) = fusion._stages
    sub = ("cpu", torch.float32, "highest")
    size = fusion._stages[key][sub].block.numel()
    monkeypatch.setattr(fusion, "_STAGE_MAX_BYTES", size + size // 2)
    for _ in range(2):
        _circuit(q, second)
    assert fusion._stages[key][sub] == fusion._SEEN
    assert fusion._stage_bytes() <= fusion._STAGE_MAX_BYTES
    _circuit(q, first)
    assert isinstance(fusion._stages[key][sub], fusion._Stage)
    assert staging.calls == 3


def test_a_governor_split_drain_finds_its_staged_passes(staging, cpu_env,
                                                        monkeypatch):
    """Under a budget that splits the program into dispatch groups, each
    group finds its passes in the plan's stage (looked up per op), and the
    states equal the unsplit drain's."""
    q = tq.createQureg(N, cpu_env)
    us = _haar(np.random.default_rng(12), N * DEPTH)
    whole = _circuit(q, us)
    program = next(iter(fusion._plan_cache.values()))
    passes = _passes(program)
    monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(_split_budget(q, program)))
    t0 = time.time_ns()
    outs = [_circuit(q, us) for _ in range(3)]
    staged = {}
    for d in _dispatches(t0):
        staged.setdefault(d["drain"], []).append(d["staged"])
    assert len(staged) == 3
    assert all(len(v) >= 2 for v in staged.values())
    assert [sum(v) for v in staged.values()] == [passes] * 3
    assert staging.calls == 1
    assert all(torch.equal(whole, o) for o in outs)


def test_a_bank_drain_stages_its_per_element_passes(staging, cpu_env):
    """A bank of per-element unitaries stages each pass's per-element
    images, one descriptor per element."""
    nb = 2
    q = tq.createBatchedQureg(N, cpu_env, nb)
    us = np.stack([_haar(np.random.default_rng([13, b]), N * DEPTH)
                   for b in range(nb)], axis=1)
    outs = [_bank_circuit(q, us) for _ in range(3)]
    (entry,) = _one_slot().values()
    assert staging.calls == 1 and entry.passes
    assert all(sp.per_element and len(sp.fields) == nb
               for sp in entry.passes.values())
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_a_staged_drain_frees_every_state_one_op_later(staging, cpu_env,
                                                       monkeypatch):
    """A drain fed from a stage holds two states at a time, as the built
    drain does: when an op starts, every state older than its input is
    already freed."""
    q = tq.createQureg(N, cpu_env)
    us = _haar(np.random.default_rng(15), N * DEPTH)
    for _ in range(2):
        _circuit(q, us)
    real = fusion.C.execute_plan
    seen, refs = [], []

    def watched(amps, ops, n, precision=None, stage=None):
        seen.append([r() is not None for r in refs])
        out = real(amps, ops, n, precision, stage=stage)
        refs.append(weakref.ref(out))
        return out

    tq.initZeroState(q)
    refs.append(weakref.ref(q._amps))
    monkeypatch.setattr(fusion.C, "execute_plan", watched)
    with tq.gateFusion(q):
        _layers(q, us, N, DEPTH, tq.unitary)
        tq.calcProbOfOutcome(q, N - 1, 0)
    assert staging.calls == 1 and len(seen) >= 3
    for alive in seen:
        assert alive[:-1] == [False] * (len(alive) - 1) and alive[-1]


def test_cpu_drains_stage_nothing_by_default(cpu_env):
    """Without a card nothing is staged or counted: the CPU runs the plain
    models, which take the plan's arrays."""
    assert fusion._STAGE_DEVICES == ("cuda",)
    fusion.clear_plan_caches()
    mode = T.mode_name()
    T.configure("on")
    try:
        q = tq.createQureg(N, cpu_env)
        us = _haar(np.random.default_rng(14), N * DEPTH)
        before = (_staged_total("stage"), _staged_total("built"))
        for _ in range(3):
            _circuit(q, us)
        assert fusion._stages == {}
        assert (_staged_total("stage"), _staged_total("built")) == before
    finally:
        T.configure(mode)
        fusion.clear_plan_caches()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_N = 20
CARD_DEPTH = 20
CARD_BANK = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m "
                    "card tests/test_torch_staging.py on one)")
    return tq.createQuESTEnv()


@pytest.mark.card
@pytest.mark.parametrize("mode", ["highest", "bf16_3x"])
@pytest.mark.parametrize("form", ["register", "bank", "split"])
def test_a_staged_drain_on_the_card_is_bit_identical(card, form, mode,
                                                     monkeypatch):
    """A 20-qubit rc26-style drain three times: the first builds its
    passes' operands as a launch does, the second and third take them
    from the stage; the three states agree bit for bit.  ``split`` runs
    under a budget that splits the program into dispatch groups, ``bank``
    a bank of 8 with per-element unitaries."""
    monkeypatch.delenv("QT_HBM_BUDGET_BYTES", raising=False)
    old, tmode = precision.get_precision(), T.mode_name()
    tq.set_precision(1)
    T.configure("on")
    fused.set_matmul_precision(mode)
    fusion.clear_plan_caches()
    G.reset()
    degr = dict(PR.DEGRADATIONS)
    try:
        rng = np.random.default_rng(2026)
        count = CARD_N * CARD_DEPTH
        if form == "bank":
            q = tq.createBatchedQureg(CARD_N, card, CARD_BANK)
            us = np.stack([_haar(rng, count) for _ in range(CARD_BANK)],
                          axis=1)

            def run():
                return _bank_circuit(q, us, CARD_N, CARD_DEPTH)
        else:
            q = tq.createQureg(CARD_N, card)
            us = _haar(rng, count)

            def run():
                return _circuit(q, us, CARD_N, CARD_DEPTH)
        if form == "split":
            run()
            program = next(iter(fusion._plan_cache.values()))
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES",
                               str(_split_budget(q, program)))
            fusion.clear_plan_caches()
        stage0, built0 = _staged_total("stage"), _staged_total("built")
        t0 = time.time_ns()
        outs = [run() for _ in range(3)]
        torch.cuda.synchronize()
        groups = _dispatches(t0)
        assert _staged_total("stage") > stage0
        passes = _staged_total("built") - built0
        assert passes > 0 and _staged_total("stage") - stage0 == 2 * passes
        if form == "split":
            assert len(groups) >= 6
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    finally:
        fusion.clear_plan_caches()
        G.reset()
        PR.DEGRADATIONS.clear()
        PR.DEGRADATIONS.update(degr)
        fused.set_matmul_precision("highest")
        T.configure(tmode)
        tq.set_precision(old)
