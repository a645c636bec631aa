"""The TPU probes on the port (``quest_tpu_torch.probes``), on the CPU.

* ``COUNTERPARTS`` holds every ``pallas_call`` site of the repository,
  both ways: the call sites an AST walk finds in every ``.py`` outside
  ``tests/`` (the JAX package's twelve and the eight of
  ``scripts/probes/``), each with a port source that defines its kernel
  and an entry function that resolves.
* Each probe's function on the port, on the CPU (the kernels' plain
  versions), against the reference probe's own Pallas kernel in interpret
  mode on the same inputs.  The reference scripts are loaded by path;
  ``jax.experimental.pallas.pallas_call`` is wrapped to pass
  ``interpret=True`` (the scripts leave it to the TPU), and ``sys.path``,
  the environment and the JAX config the scripts touch at import are
  restored after each test.  Tolerances:
  - the offset-window cluster pass (K1) and ``sep_window`` given A^T
    against K1's plain version: 1e-5 max|psi| (float32 sums of 128-term
    products taken in another order);
  - v2 and v4 against "highest": 1e-5 max|psi|; v1 and v3 against the
    port's "bf16_3x" model: 4e-6 max|psi|, that mode's tolerance in
    ``tests/test_torch_precisions.py`` (the same exact bf16 products,
    summed in another order);
  - the flip program against the port's plain Trotter route: 1e-6, the
    reference probe's own assert;
  - the stream pass's plain version against the reference's copy / x2
    chain: exactly.
* Every probe's ``check`` passes on the CPU, and its ``run`` (the card's
  timings) refuses the CPU.
"""

import ast
import functools
import importlib
import importlib.util
import inspect
import os
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu_torch.ops import fused, stream
from quest_tpu_torch.probes import (COUNTERPARTS, PROBES, common,
                                    kernel_microbench, probe_flip_pallas,
                                    probe_kernel_variants,
                                    profile_rank_kernels)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROBE_DIR = REPO / "scripts" / "probes"
TOL = 1e-5
TOL_BF16 = 4e-6
N = 16
SEED_QUIRK = 4


# ---------------------------------------------------------------------------
# (a) every pallas_call site has its counterpart
# ---------------------------------------------------------------------------


def _ignored_dirs() -> set:
    """The directories ``.gitignore`` lists (generated files, outside what
    git tracks), as written there."""
    lines = (REPO / ".gitignore").read_text().splitlines()
    return {ln.strip().rstrip("/") for ln in lines
            if ln.strip().endswith("/") and not ln.startswith("#")}


def _pallas_call_sites() -> set:
    ignored = _ignored_dirs()
    sites = set()
    for root, dirs, files in os.walk(REPO):
        here = Path(root).relative_to(REPO)
        dirs[:] = sorted(d for d in dirs if not d.startswith(".")
                         and d not in ignored
                         and (here / d).as_posix() not in ignored
                         and not (here == Path(".") and d == "tests"))
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = (here / name).as_posix()
            tree = ast.parse((REPO / rel).read_text(), filename=rel)
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    f = node.func
                    if ((isinstance(f, ast.Attribute)
                         and f.attr == "pallas_call")
                            or (isinstance(f, ast.Name)
                                and f.id == "pallas_call")):
                        sites.add(f"{rel}:{node.lineno}")
    return sites


def test_counterparts_are_every_pallas_call_site():
    sites = _pallas_call_sites()
    assert len(sites) == 20
    assert sites - set(COUNTERPARTS) == set(), "a site without counterpart"
    assert set(COUNTERPARTS) - sites == set(), "a counterpart of no site"


@pytest.mark.parametrize("site", sorted(COUNTERPARTS))
def test_counterpart_kernel_and_entry_exist(site):
    label, source, kernel, entry = COUNTERPARTS[site]
    text = (REPO / source).read_text()
    assert f"{kernel}(" in text and "__global__" in text, (site, kernel)
    module, name = entry.rsplit(".", 1)
    assert callable(getattr(importlib.import_module(module), name)), entry
    assert label[0] == ("P" if site.startswith("scripts/") else "K")


def test_counterpart_labels_are_k1_to_k12_and_p1_to_p8():
    labels = sorted(v[0] for v in COUNTERPARTS.values())
    assert labels == sorted([f"K{i}" for i in range(1, 13)]
                            + [f"P{i}" for i in range(1, 9)])


# ---------------------------------------------------------------------------
# (b) each probe against the reference probe's kernel, interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_probe(monkeypatch, tmp_path):
    """Loads ``scripts/probes/<name>.py`` by path with every pallas_call in
    interpret mode; the scripts' sys.path inserts, their environment
    default and their JAX config update are undone afterwards."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    saved = jax.config.jax_persistent_cache_min_compile_time_secs

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_reference_probe_{name}", PROBE_DIR / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved)


def _np(t):
    return np.asarray(t).reshape(2, -1)


STREAM_CASES = [(op, rows, alias) for op in ("copy", "scale")
                for rows in (4, 8, 16) for alias in (True, False)]


@pytest.mark.parametrize("op,rows,alias", STREAM_CASES)
def test_stream_plain_equals_the_reference_chain(ref_probe, monkeypatch, op,
                                                 rows, alias):
    """Two passes of the reference's copy / x2 chain at 18 qubits
    (captured pass by pass with jit off) against two passes of
    ``stream_pass_plain``: exactly."""
    n, passes = 18, 2
    ref = ref_probe("profile_dma")
    monkeypatch.setattr(ref, "AMPS", 1 << n)
    monkeypatch.setattr(ref, "K", passes)
    seen = []
    inner = jpl.pallas_call

    def capture(*args, **kw):
        call = inner(*args, **kw)

        def run(*xs):
            out = call(*xs)
            seen.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(jpl, "pallas_call", capture)
    x0 = common.random_state(n, 5)
    kernel = ref.copy_kernel if op == "copy" else ref.scale_kernel
    with jax.disable_jit():
        ref.make_pallas_chain(kernel, rows, alias)(jnp.asarray(x0))
    assert len(seen) == passes
    x = torch.from_numpy(x0.copy())
    for _ in range(passes):
        out = None if alias else torch.empty_like(x)
        x = stream.stream_pass_plain(x, rows=rows, op=op, out=out)
    assert np.array_equal(_np(seen[-1]), x.numpy())


@pytest.mark.parametrize("case", kernel_microbench.cases(N),
                         ids=lambda c: f"k{c[0]}-rank{c[1]}-"
                         f"{'AB' if c[2] else 'B'}")
def test_offset_cluster_matches_the_reference(ref_probe, case):
    ref = ref_probe("kernel_microbench")
    k, _rank, apply_a, _seed = case
    x, a, b = kernel_microbench.inputs(N, case)
    want = _np(ref.apply_offset_cluster(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), num_qubits=N, k=k,
        apply_a=apply_a))
    got = kernel_microbench.apply_offset_cluster(
        torch.from_numpy(x), a, b, num_qubits=N, k=k, apply_a=apply_a)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(x).max()


@pytest.mark.parametrize("label,apply_a,with_mask",
                         probe_kernel_variants.SEP_CASES)
def test_sep_window_matches_the_reference(ref_probe, label, apply_a,
                                          with_mask):
    """The reference's sep_window and the port's (K1 given A^T) on the
    same A: equal within K1's tolerance."""
    ref = ref_probe("probe_kernel_variants")
    k = probe_kernel_variants.offset(N)
    a, b, mask = probe_kernel_variants.inputs()
    x = common.random_state(N, 3)
    want = _np(ref.sep_window(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
        num_qubits=N, k=k, apply_a=apply_a, with_mask=with_mask))
    got = probe_kernel_variants.sep_window(
        torch.from_numpy(x), a, b, mask, num_qubits=N, k=k, apply_a=apply_a,
        with_mask=with_mask)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(x).max()


def test_sep_window_lane_side_is_transposed(ref_probe):
    """The reference probe's quirk: its sep_window multiplies the lanes by
    A where its K1 takes A^T, so its check_AB compares two functions; the
    port's check records the same difference, and none with A^T."""
    ref = ref_probe("probe_kernel_variants")
    k = probe_kernel_variants.offset(N)
    a, b, _mask = probe_kernel_variants.inputs()
    x = common.random_state(N, SEED_QUIRK)
    # each call donates its state: a fresh device array each
    v0 = _np(ref.fused.apply_window_stack(
        jnp.asarray(x), jnp.asarray(a)[None], jnp.asarray(b)[None],
        num_qubits=N, k=k))
    v1 = _np(ref.sep_window(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                            num_qubits=N, k=k))
    v1t = _np(ref.sep_window(jnp.asarray(x),
                             jnp.asarray(np.swapaxes(a, -1, -2)),
                             jnp.asarray(b), num_qubits=N, k=k))
    tol = TOL * float(np.abs(x).max())
    assert np.abs(v0 - v1).max() > 100 * tol
    assert np.abs(v0 - v1t).max() <= tol
    lane = probe_kernel_variants.check("cpu", N)["lane_side"]
    assert lane["v0_minus_v1_same_a"] > 100 * tol
    assert lane["v0_minus_v1_given_a_t"] <= tol


RANK_CASES = [(v, rank) for v in ("v1", "v2", "v3", "v4") for rank in (2, 4)]


@pytest.mark.parametrize("variant,rank", RANK_CASES)
def test_rank_variant_matches_the_reference(ref_probe, monkeypatch, variant,
                                            rank):
    ref = ref_probe("profile_rank_kernels")
    monkeypatch.setattr(ref, "AMPS", 1 << N)
    x, a, b = profile_rank_kernels.inputs(N, rank, rank)
    want = _np(ref.RUNNERS[variant](jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(b), rank, 4))
    prec = profile_rank_kernels.VARIANT_PRECISION[variant]
    got = profile_rank_kernels.rank_pass(
        torch.from_numpy(x), a, b, num_qubits=N, precision=prec).numpy()
    tol = TOL if prec == "highest" else TOL_BF16
    assert np.abs(got - want).max() <= tol * np.abs(x).max()


def test_flip_program_matches_the_reference(ref_probe):
    """The reference probe's 16-term program at 16 qubits against the
    port's plain Trotter route and its K3 route (the plain version on the
    CPU): within the probe's 1e-6."""
    ref = ref_probe("probe_flip_pallas")
    codes, angles, a0 = probe_flip_pallas.inputs(N)
    want = _np(ref.build(N)(jnp.asarray(a0), jnp.asarray(codes, jnp.int32),
                            jnp.asarray(angles)))
    plain = probe_flip_pallas.take_take(torch.from_numpy(a0), codes, angles,
                                        num_qubits=N).numpy()
    k3 = probe_flip_pallas.flip_program(torch.from_numpy(a0.copy()), codes,
                                        angles, num_qubits=N).numpy()
    assert np.abs(plain - want).max() < probe_flip_pallas.MAXDIFF
    assert np.abs(k3 - want).max() < probe_flip_pallas.MAXDIFF


# ---------------------------------------------------------------------------
# check on the CPU, run refuses it, the stream wrapper's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROBES)
def test_check_passes_on_the_cpu(name):
    n = 18 if name == "profile_dma" else N
    res = importlib.import_module(f"quest_tpu_torch.probes.{name}").check(
        "cpu", n)
    assert res["n"] == n and res["max_abs_err"] == 0.0


@pytest.mark.parametrize("name", PROBES)
def test_run_refuses_the_cpu(name):
    mod = importlib.import_module(f"quest_tpu_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        mod.run("cpu")


def test_stream_pass_refuses_a_cpu_tensor():
    x = torch.zeros((2, 1 << 16))
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        stream.stream_pass(x, rows=4, op="copy")
    assert stream.LAUNCHES["P1"] == 0


@pytest.mark.parametrize("kwargs,match", [
    ({"rows": 3, "op": "copy"}, "does not divide"),
    ({"rows": 4, "op": "negate"}, "is not one of"),
    ({"rows": 8, "op": "copy"}, "does not divide"),
])
def test_stream_plain_checks_as_the_kernel(kwargs, match):
    x = torch.zeros((2, 1 << 16))      # 4 rows a plane
    with pytest.raises(ValueError, match=match):
        stream.stream_pass_plain(x, **kwargs)


def test_stream_plain_out_and_in_place():
    x = torch.from_numpy(common.random_state(15, 1))
    out = torch.empty_like(x)
    y = stream.stream_pass_plain(x, rows=2, op="scale", scale=0.5, out=out)
    assert y is out and torch.equal(out, x * 0.5)
    z = stream.stream_pass_plain(x.clone(), rows=1, op="copy")
    assert torch.equal(z, x)
    buf = torch.zeros(2 * x.numel())
    a = buf[:x.numel()].view(x.shape)
    with pytest.raises(ValueError, match="overlaps"):
        stream.stream_pass_plain(a, rows=1, op="copy",
                                 out=buf[4:4 + x.numel()].view(x.shape))


@pytest.mark.parametrize("name", PROBES)
def test_check_names_its_device(name):
    """A probe's check runs where its caller says: it has no default
    device, so no bare call compares a plain version with itself."""
    check = importlib.import_module(f"quest_tpu_torch.probes.{name}").check
    params = inspect.signature(check).parameters
    assert params["device"].default is inspect.Parameter.empty


# ---------------------------------------------------------------------------
# the library yardsticks compute the functions of the passes they time
# ---------------------------------------------------------------------------


def _planes(z, axis=0):
    """A complex einsum result as SoA planes on ``axis``."""
    return torch.view_as_real(z).movedim(-1, axis)


@pytest.mark.parametrize("rank,apply_a,with_mask", [
    (1, True, False), (1, True, True), (1, False, False), (1, False, True),
    (2, True, False), (2, False, True)])
def test_window_library_computes_the_window_pass(rank, apply_a, with_mask):
    n, k = 16, 8
    rng = np.random.default_rng(30 + rank)
    x = torch.from_numpy(common.random_state(n, rank))
    a = torch.from_numpy(common.side_stack(rng, rank))
    b = torch.from_numpy(common.side_stack(rng, rank))
    mask = None
    if with_mask:
        ph = rng.uniform(0, 2 * np.pi, (128, 128))
        mask = torch.from_numpy(np.stack([np.cos(ph), np.sin(ph)])
                                .astype(np.float32))
    want = fused.window_pass_plain(x, a, b, mask, num_qubits=n, k=k,
                                   apply_a=apply_a)
    forms = common.window_library(x, a, b, mask, num_qubits=n, k=k,
                                  apply_a=apply_a)
    assert len(forms) == (2 if apply_a else 1)
    for sub, fn in forms.items():
        got = _planes(fn()).reshape(want.shape)
        assert float((got - want).abs().max()) <= common.tolerance(x), sub


@pytest.mark.parametrize("rank,swap", [(1, None), (2, None), (1, (14, 7, 3)),
                                       (2, (14, 8, 2))])
def test_cluster_library_computes_k11_and_k12(rank, swap):
    n = 17
    rng = np.random.default_rng(40 + rank)
    x = torch.from_numpy(common.random_state(n, rank)).reshape(
        2, 1 << (n - 14), 128, 128)
    a = torch.from_numpy(common.side_stack(rng, rank))
    b = torch.from_numpy(common.side_stack(rng, rank))
    if swap is None:
        want = fused.cluster_stack_plain(x, a, b, num_qubits=n)
    else:
        want = fused.swap_cluster_stack_plain(x, a, b, num_qubits=n,
                                              h=swap[0], b=swap[1],
                                              m=swap[2])
    forms = common.cluster_library(x, a, b, swap)
    assert len(forms) == 4
    for sub, fn in forms.items():
        got = _planes(fn()).reshape(want.shape)
        assert float((got - want).abs().max()) <= common.tolerance(x), sub


@pytest.mark.parametrize("swap", [None, (14, 7, 3)])
def test_cluster_library_bank_form_is_per_element(swap):
    """With ``bank`` the element is an axis of every operand: element e of
    the one call is the pass of element e's rank-1 sides on its state."""
    n, nb = 17, 3
    rng = np.random.default_rng(50)
    x = torch.stack([torch.from_numpy(common.random_state(n, 60 + e))
                     for e in range(nb)])
    a = torch.from_numpy(np.stack([common.side_stack(rng, 1)
                                   for _ in range(nb)]))
    b = torch.from_numpy(np.stack([common.side_stack(rng, 1)
                                   for _ in range(nb)]))
    want = []
    for e in range(nb):
        if swap is None:
            want.append(fused.cluster_stack_plain(x[e], a[e], b[e],
                                                  num_qubits=n))
        else:
            want.append(fused.swap_cluster_stack_plain(
                x[e], a[e], b[e], num_qubits=n, h=swap[0], b=swap[1],
                m=swap[2]))
    want = torch.stack(want)
    forms = common.cluster_library(x, a, b, swap, bank=True)
    assert len(forms) == 4 and all(sub.startswith("z") for sub in forms)
    for sub, fn in forms.items():
        got = _planes(fn(), 1).reshape(want.shape)
        assert float((got - want).abs().max()) <= common.tolerance(x), sub


def test_window_bound_is_the_bound_of_its_pass():
    """The probes' bound of a pass and chip_smoke's bound of the same pass
    as an op are one function."""
    num_amps = 1 << 26
    for rank, sides, mask in ((1, 2, False), (4, 2, False), (1, 1, True)):
        a = torch.zeros((rank, 2, 128, 128))
        m = torch.zeros((2, 128, 128)) if mask else None
        op = ("winfused", 14, a, a, sides == 2, True, m)
        for prec in ("highest", "bf16_3x"):
            assert common.window_bound(num_amps, rank, sides, mask, prec) \
                == common.bound_ms([op], 8 * num_amps, num_amps, "float32",
                                   rate=common.MODE_FLOPS[prec])
