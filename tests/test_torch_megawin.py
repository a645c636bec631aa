"""The window megakernel (K2) of quest_tpu_torch: its groups against
quest_tpu, and its ticket schedule on the host.

* The shapes of bench.py config 2's megawin groups (26 qubits, depth 20:
  groups A and B, a B-only and a dual pass at k = 7 with masks, G = 1;
  group C, five passes up to a B-only pass at k = 10, G = 8), at n = 18
  (the k = 10 pass needs n >= 17), float32 and float64: the port's
  ``apply_window_megastack`` (on the CPU, ``megawin_plain``) against the
  reference's ``apply_window_megastack(..., interpret=True)``, and bit for
  bit against its passes run one by one.
* ``megawin_schedule``: K2's workspace at 26 qubits stays below a quarter
  of the state and its slot ring spans a window; the ticket map
  (``megawin_decode``, the twin of csrc/window.cu ``mega_decode``) runs
  every item once, every item's inputs hold lower tickets, and a
  simulated run of the kernel's rules on few or many CTAs never deadlocks
  and never reuses a buffer while it is live.
* The wrapper's argument checks, and its ctypes signature of K2's C
  entries against csrc/window.cu.

Tolerance against the reference: 1e-10 absolute at float64 (the file
tests/test_torch_fused.py states why); at float32, 1e-5 of the state's
largest amplitude per pass (sums of 128-term products of unit-scale
factors, each rounded at 2^-24, in another order than the reference's).
"""

import ctypes
import pathlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quest_tpu.ops import fused as ref_fused
from quest_tpu_torch.ops import fused

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-10
N = 18

# (k, rank, sides, mask) of config 2's megawin groups
_BENCH_GROUPS = {
    "AB": [(7, 1, "B", True), (7, 1, "AB", True)],
    "C": [(7, 1, "B", True), (7, 1, "AB", True), (7, 1, "AB", True),
          (7, 1, "AB", False), (10, 1, "B", False)],
}


def _unitary(rng, dim):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _pass(rng, k, rank, sides, with_mask, dt):
    def stack():
        return np.stack([np.stack([u.real, u.imag]) / rank
                         for u in (_unitary(rng, 128) for _ in range(rank))]
                        ).astype(dt)
    mask = None
    if with_mask:
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (128, 128)))
        mask = np.stack([ph.real, ph.imag]).astype(dt)
    return ("winfused", k, stack(), stack(), "A" in sides, "B" in sides,
            mask)


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("name", sorted(_BENCH_GROUPS))
def test_bench_group_matches_reference(name, dt):
    spec = _BENCH_GROUPS[name]
    rng = np.random.default_rng(300 + len(spec))
    x = rng.standard_normal((2, 1 << N))
    x = (x / np.sqrt((x ** 2).sum())).astype(dt)
    group = [_pass(rng, k, r, s, m, dt) for k, r, s, m in spec]
    want = np.asarray(ref_fused.apply_window_megastack(
        jnp.asarray(x), group, num_qubits=N, interpret=True))
    got = fused.apply_window_megastack(torch.from_numpy(x), group,
                                       num_qubits=N)
    assert got.dtype == torch.from_numpy(x).dtype
    tol = TOL if dt == np.float64 else 1e-5 * float(np.abs(x).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=len(group) * tol)
    per_pass = torch.from_numpy(x)
    for op in group:
        per_pass = fused.apply_window_stack(
            per_pass, op[2], op[3], op[6], num_qubits=N, k=op[1],
            apply_a=op[4], apply_b=op[5])
    assert torch.equal(got, per_pass)


# -------------------------------------------------------------------------
# The ticket schedule
# -------------------------------------------------------------------------

CTAS = 132      # an H100's SMs, one K2 CTA each


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("g", [1, 8])
def test_workspace_fits_beside_the_state(g, dtype):
    n = 26
    state_bytes = 2 * (1 << n) * (4 if dtype == torch.float32 else 8)
    s = fused.megawin_schedule(n, g, 5, dtype, CTAS)
    assert s["super_blocks"] == (1 << (n - 14)) // g
    assert s["workspace_bytes"] <= state_bytes // 4
    assert s["slot_bytes"] <= s["workspace_bytes"]
    # the slot ring spans a window, and a window's pass keeps every CTA
    # in items twice over
    assert s["window"] <= s["slots"] <= 2 * s["window"]
    assert (s["window"] * s["items_per_pass"]
            >= fused.MEGA_ITEMS_PER_CTA * CTAS)


def test_one_pass_needs_no_slots():
    s = fused.megawin_schedule(20, 8, 1, torch.float32, CTAS)
    assert s["slots"] == 0 and s["slot_bytes"] == 0
    assert s["workspace_bytes"] == 4 * (1 + s["super_blocks"])


# (num_qubits, g, npass, dtype, ctas): the bench groups at 26 and 20
# qubits, a ragged last window, one pass, odd and even pass counts, fewer
# CTAs than a pass has items
_SCHEDULES = [
    (26, 8, 5, torch.float32, CTAS), (26, 1, 2, torch.float32, CTAS),
    (20, 8, 5, torch.float32, CTAS), (20, 1, 2, torch.float64, CTAS),
    (20, 2, 3, torch.float32, 7), (18, 4, 4, torch.float64, 3),
    (17, 1, 1, torch.float32, 5), (19, 2, 6, torch.float32, 40),
]


def _items(sched, npass):
    """Every item in ticket order, with its ticket."""
    out = []
    for t in range(sched["tickets"]):
        sb, p, it = fused.megawin_decode(t, sched, npass)
        out += [((sb, p, it + i), t) for i in range(fused.MEGA_TICKET_ITEMS)]
    return out


@pytest.mark.parametrize("case", _SCHEDULES)
def test_ticket_map_runs_every_item_once_after_its_inputs(case):
    n, g, npass, dtype, ctas = case
    s = fused.megawin_schedule(n, g, npass, dtype, ctas)
    nsb, ipp, slots = s["super_blocks"], s["items_per_pass"], s["slots"]
    items = _items(s, npass)
    assert sorted(i for i, _ in items) == [
        (sb, p, it) for sb in range(nsb) for p in range(npass)
        for it in range(ipp)]
    ticket = dict(items)
    last = {}
    for (sb, p, _), t in ticket.items():
        last[sb, p] = max(last.get((sb, p), -1), t)
    first_slot = fused.megawin_first_slot_pass(npass)
    for (sb, p, _), t in ticket.items():
        if p > 0:
            assert last[sb, p - 1] < t
        if p == first_slot and sb >= slots:
            # the slot's previous occupant is done before it is written
            assert last[sb - slots, npass - 1] < t
    # a ticket's items share their super-block and pass
    for t in range(s["tickets"]):
        assert len({(sb, p) for (sb, p, _), u in items if u == t}) == 1


def _simulate(s, npass, workers, seed):
    """K2's rules run by ``workers`` CTAs in a random interleaving: each
    takes tickets in order, one at its start and its next as each ticket
    starts, starts a ticket when its inputs are done, and a finished
    ticket adds its items to its super-block's done-counter.  Asserts
    that every item reads its pass's complete input and that no buffer is
    overwritten while an item still reads it; returns the finish order."""
    nsb, ipp, slots = s["super_blocks"], s["items_per_pass"], s["slots"]
    total = s["tickets"]
    per = fused.MEGA_TICKET_ITEMS
    first_slot = fused.megawin_first_slot_pass(npass)
    done = [0] * nsb
    content: dict = {}         # buffer -> [writer (sb, pass), items written]
    running: list = []         # (worker, item)
    held = {}                  # worker -> its current and next ticket
    nxt = 0
    rnd = random.Random(seed)
    finished = []

    def dst(sb, p):
        if (npass - 1 - p) % 2 == 0:
            return ("out", sb)
        return ("slot", sb % slots)

    def src(sb, p):
        return ("x", sb) if p == 0 else dst(sb, p - 1)

    def ready(sb, p):
        if p > 0 and done[sb] < p * ipp:
            return False
        if p == first_slot and sb >= slots and done[sb - slots] < npass * ipp:
            return False
        return True

    for w in range(workers):
        held[w] = [nxt]
        nxt += 1
    while len(finished) < total:
        moves = [("finish", r) for r in running]
        for w, tickets in held.items():
            if tickets[0] < total and all(r[0] != w for r in running):
                sb, p, _ = fused.megawin_decode(tickets[0], s, npass)
                if ready(sb, p):
                    moves.append(("start", w))
        assert moves, "the schedule deadlocked"
        kind, arg = rnd.choice(moves)
        if kind == "start":
            w = arg
            sb, p, it = fused.megawin_decode(held[w][0], s, npass)
            held[w].append(nxt)
            nxt += 1
            if p > 0:
                assert content[src(sb, p)] == [(sb, p - 1), ipp // per]
            out = dst(sb, p)
            owner = content.get(out)
            if owner is not None and owner[0] != (sb, p):
                # nobody still reads what is about to be overwritten
                assert all(src(*r[1][:2]) != out for r in running)
                content[out] = [(sb, p), 0]
            elif owner is None:
                content[out] = [(sb, p), 0]
            running.append((w, (sb, p, it)))
        else:
            running.remove(arg)
            w, (sb, p, it) = arg
            content[dst(sb, p)][1] += 1
            done[sb] += per
            finished.append((sb, p, it))
            held[w].pop(0)
    assert done == [npass * ipp] * nsb
    return finished


@pytest.mark.parametrize("workers", [1, 3, 16, 64])
@pytest.mark.parametrize("case", _SCHEDULES[2:])
def test_schedule_never_deadlocks_or_reuses_a_live_buffer(case, workers):
    n, g, npass, dtype, ctas = case
    s = fused.megawin_schedule(n, g, npass, dtype, ctas)
    finished = _simulate(s, npass, workers, seed=workers * 31 + n)
    assert len(set(finished)) == len(finished)


# -------------------------------------------------------------------------
# Argument checks
# -------------------------------------------------------------------------


def test_megastack_rejects_too_many_passes():
    rng = np.random.default_rng(4)
    op = _pass(rng, 7, 1, "AB", False, np.float64)
    x = torch.zeros((2, 1 << 14), dtype=torch.float64)
    with pytest.raises(ValueError, match="1..16 passes"):
        fused.apply_window_megastack(x, [op] * (fused.MAX_MEGA_PASSES + 1),
                                     num_qubits=14)
    with pytest.raises(ValueError, match="1..16 passes"):
        fused.apply_window_megastack(x, [], num_qubits=14)


@pytest.mark.parametrize("k,n", [(6, 16), (10, 16), (8, 14)])
def test_megastack_rejects_offsets_out_of_range(k, n):
    rng = np.random.default_rng(5)
    op = _pass(rng, k, 1, "B", False, np.float64)
    with pytest.raises(ValueError):
        fused.apply_window_megastack(
            torch.zeros((2, 1 << n), dtype=torch.float64), [op],
            num_qubits=n)


def test_kernel_state_checks_reject_misaligned_operands():
    """The kernels copy the state in 16-byte pieces: a view that starts
    off a 16-byte boundary, a strided view or an integer state is
    refused before any launch."""
    base = torch.zeros(2 * (1 << 14) + 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="16 bytes"):
        fused._check_cuda_state(base[1:1 + 2 * (1 << 14)],
                                "apply_window_megastack")
    with pytest.raises(ValueError, match="contiguous"):
        fused._check_cuda_state(base[: 2 * (1 << 14)].reshape(2, -1)[:, ::2],
                                "apply_window_megastack")
    with pytest.raises(TypeError):
        fused._check_cuda_state(torch.zeros(8, dtype=torch.int32),
                                "apply_window_megastack")


def test_megawin_entry_signature_matches_the_source():
    """fused.MEGAWIN_ARGTYPES declares qt_megawin_f32/_f64 as
    csrc/window.cu defines them: one ctypes type per C parameter, a
    pointer for each pointer, c_int for each int, the pass array as
    _QtPass*."""
    src = (pathlib.Path(fused.__file__).parent.parent / "csrc"
           / "window.cu").read_text()
    for name, real in (("qt_megawin_f32", "float"),
                       ("qt_megawin_f64", "double")):
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        want = []
        for p in params:
            if p.startswith("const QtPass*"):
                want.append(ctypes.POINTER(fused._QtPass))
            elif "*" in p:
                want.append(ctypes.c_void_p)
            else:
                assert p.startswith("int "), p
                want.append(ctypes.c_int)
        assert list(fused.MEGAWIN_ARGTYPES) == want, name
        assert f"{real}* out" in m.group(1)
    # the host twin of the ticket map counts the kernel's items a ticket
    assert (int(re.search(r"constexpr int MEGA_TICKET_ITEMS = (\d+);",
                          src).group(1)) == fused.MEGA_TICKET_ITEMS)
