"""One run of one cell: set-up, the measured window, the traced reading,
the comparison with the plain reference, and the result's line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``, the
file that ``BENCHMARK.json`` gives) and its traffic
(``traffic/<name>.json``); the configuration names its circuit family
(``circuits/<circuit>.py``); the cell's own file (``workloads/<cell>.json``)
holds the limits of its comparison and its control; each per-layer metric
is ``metrics/<metric>.py``.  Adding a cell, a mix or a metric adds files
and entries and edits none.

Every cell is a closed loop with one client: a circuit is the
re-initialisation of the register (or bank) made at set-up, the circuit's
calls through the public API under ``gateFusion``, and a read-out that
returns a float to the host.  The next circuit starts when the read-out
has returned.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"

# Top-level modules that may not be loaded in the process that prints the
# result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "quest_tpu")


def set_cache_dirs() -> None:
    """Every cache of the program and of the libraries it may use, at
    fixed paths inside the checkout, and one host thread for the math
    libraries, so that the run's load is one process's (before the
    program is imported)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["QT_AOT_CACHE"] = str(CACHE / "plans")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's, by file (names may hold dots)."""
    name = "qtbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"BENCHMARK.json has no {what} named {name!r}")


def load_cell(workload: str, overrides: dict | None = None):
    """(benchmark, cell entry, configuration, traffic, cell file)."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = _named(spec["workloads"], workload, "workload")
    cfg_entry = _named(spec["configs"], cell["config"], "configuration")
    cfg = load_json(ROOT / cfg_entry["file"])
    cfg.update(overrides or {})
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise SystemExit(f"traffic {cell['traffic']!r}: the harness drives "
                         "one client in a closed loop")
    cell_file = load_json(BENCH / "workloads" / f"{workload}.json")
    return spec, cell, cfg, traffic, cell_file


def cell_metrics(spec: dict, kind: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------


class Cell:
    """The register or bank, the calls and the read-out of one cell, made
    from the seed at set-up."""

    def __init__(self, qt, torch, cfg, traffic, seed: int, device: str,
                 matmul_precision: str):
        from quest_tpu_torch.ops import fused

        self.qt, self.torch = qt, torch
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.n = int(cfg["num_qubits"])
        self.batch = int(traffic.get("batch", 0))
        self.readout_qubit = self.n - 1
        qt.set_precision(int(cfg["quest_precision"]))
        fused.set_matmul_precision(matmul_precision)
        self.env = (qt.createQuESTEnv(device="cpu") if device == "cpu"
                    else qt.createQuESTEnv())
        circuit = load_module(BENCH / "circuits" / f"{cfg['circuit']}.py")
        if self.batch:
            self.calls, self.element_calls = circuit.bank_calls(
                cfg, seed, self.batch)
            self.q = qt.createBatchedQureg(self.n, self.env, self.batch)
        else:
            # a mix may name one of the circuit's routes (its other ways
            # of writing the same circuit); the circuit's own default else
            route = ({"route": traffic["route"]} if "route" in traffic
                     else {})
            self.calls = circuit.register_calls(cfg, seed, **route)
            self.element_calls = [self.calls]
            self.q = qt.createQureg(self.n, self.env)
        self.device = self.q.device
        self.resolved = [(getattr(qt, name), args)
                         for name, args in self.calls]
        self.source = None
        if cfg["init"] == "random":
            state = random_state(torch, self.n, seed, self.device)
            self.source = qt.createQureg(self.n, self.env)
            self.source.amps = state
            del state
        elif cfg["init"] != "zero":
            raise ValueError(f"unknown init {cfg['init']!r}")
        self.z_codes = [[0] * self.readout_qubit + [3]]

    def init(self) -> None:
        if self.source is None:
            self.qt.initZeroState(self.q)
        else:
            self.qt.cloneQureg(self.q, self.source)

    def readout(self):
        """P(top qubit = 0) of the register; of a bank, each element's
        <Z> of the top qubit (= 2 P - 1) through the bank's API."""
        if self.batch:
            return [float(v) for v in self.qt.calcExpecPauliSumBatched(
                self.q, self.z_codes, [1.0])]
        return [self.qt.calcProbOfOutcome(self.q, self.readout_qubit, 0)]

    def run_once(self):
        """One circuit: (read-outs, wall seconds, seconds in the calls)."""
        rf = self.torch.profiler.record_function
        t0 = time.perf_counter()
        with rf("qtbench.circuit"):
            with rf("qtbench.init"):
                self.init()
            with self.qt.gateFusion(self.q):
                tg = time.perf_counter()
                with rf("qtbench.gate_calls"):
                    for fn, args in self.resolved:
                        fn(self.q, *args)
                tg = time.perf_counter() - tg
                with rf("qtbench.readout"):
                    out = self.readout()
        return out, time.perf_counter() - t0, tg

    def program_plan(self):
        """The program the circuit's drain runs (empty for a circuit
        that buffers nothing, such as ``applyFullQFT``), read after the
        window: the calls are buffered once more and the plan looked up as
        the drain looks it up, then the circuit runs, so the register ends
        as every circuit leaves it."""
        from quest_tpu_torch import fusion

        self.init()
        with self.qt.gateFusion(self.q):
            for fn, args in self.resolved:
                fn(self.q, *args)
            items = list(self.q._fusion.gates)
            program = fusion.plan_items_quiet(self.q, items)[0]
            self.readout()
        return program

    def final_states(self):
        """The register's (or each bank element's) final state, (2, 2^n)
        float32 tensors on the device."""
        amps = self.q.amps
        return [amps[b] for b in range(self.batch)] if self.batch \
            else [amps]

    def free_inputs(self) -> None:
        if self.source is not None:
            self.qt.destroyQureg(self.source, self.env)
            self.source = None


def random_state(torch, n: int, seed: int, device):
    """A normalised random state of 2^n amplitudes, (2, 2^n) float32,
    made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randn((2, 1 << n), generator=gen, device=device,
                    dtype=torch.float32)
    flat = x.view(-1)
    block = 1 << 24
    total = sum(float(torch.sum(flat[s:s + block].double() ** 2))
                for s in range(0, flat.numel(), block))
    return x.div_(math.sqrt(total))


# ---------------------------------------------------------------------------
# the traced window's reading
# ---------------------------------------------------------------------------


def window_launch_costs(program, num_amps: int) -> list:
    """[(bytes, operations) or None] of each window-kernel launch of a
    drain of ``program``, in launch order (None where the launch's shape
    is not read: its bytes alone then bound it)."""
    from qtbench import roofline as RF

    def one(op):
        rank = int(op[2].shape[-4])
        sides = int(bool(op[4])) + int(bool(op[5]))
        mask = len(op) > 6 and op[6] is not None
        return rank, sides, mask

    out = []
    for part in program:
        if part[0] in ("chan", "chansweep", "remap"):
            continue
        for op in part[1]:
            if op[0] == "winfused":
                out.append(RF.window_pass_cost(*one(op), num_amps))
            elif op[0] == "megawin":
                if all(p[0] == "winfused" for p in op[1]):
                    out.append(RF.group_cost([one(p) for p in op[1]],
                                             num_amps))
                else:
                    out.append(None)
            elif op[0] in ("fused", "swapfused"):
                out.append(None)
    return out


# ---------------------------------------------------------------------------
# the comparison with the reference
# ---------------------------------------------------------------------------


def reference_states(torch, cell_like, element: int, tf32: bool = False):
    """Element ``element``'s reference final state (complex128; complex64
    for the TF32 control) on the device, from the inputs alone."""
    from qtbench.reference import statevec as R

    dev = cell_like.device
    dtype = torch.complex64 if tf32 else torch.complex128
    n = cell_like.n
    if cell_like.cfg["init"] == "random":
        x = random_state(torch, n, cell_like.seed, dev)
        psi = torch.complex(x[0].to(dtype.to_real()),
                            x[1].to(dtype.to_real()))
        del x
    else:
        psi = torch.zeros(1 << n, dtype=dtype, device=dev)
        psi[0] = 1.0
    R.apply_calls(psi, cell_like.element_calls[element], tf32=tf32)
    return psi


def state_error(torch, prog, ref, block: int = 1 << 24) -> float:
    """||prog - ref|| / ||ref||, prog a (2, 2^n) real state, ref complex,
    summed in float64 in blocks."""
    num = den = 0.0
    for s in range(0, ref.numel(), block):
        r = ref[s:s + block].to(torch.complex128)
        p = torch.complex(prog[0, s:s + block].double(),
                          prog[1, s:s + block].double())
        num += float(torch.sum(torch.abs(p - r) ** 2))
        den += float(torch.sum(torch.abs(r) ** 2))
    return math.sqrt(num / den)


def readout_of(cell_like, psi) -> float:
    """The read-out the cell's circuits return, of a reference state."""
    from qtbench.reference import statevec as R

    p = R.prob_of_outcome(psi, cell_like.readout_qubit, 0)
    return 2.0 * p - 1.0 if cell_like.batch else p


def compare(torch, cell, reads, finals, tf32_control: bool) -> dict:
    """The numbers compared: ``state_err``, the largest relative distance
    of a final state (``finals``) from the reference's, and
    ``readout_err``, the largest gap of any read-out of the window from
    the reference's.  With ``tf32_control`` the reference in TF32 stands
    in the program's place."""
    state_err, readout_err = 0.0, 0.0
    for b in range(max(cell.batch, 1)):
        ref = reference_states(torch, cell, b)
        want = readout_of(cell, ref)
        if tf32_control:
            low = reference_states(torch, cell, b, tf32=True)
            prog = torch.stack([low.real, low.imag])
            got = [readout_of(cell, low)]
            del low
        else:
            prog = finals[b]
            got = [r[b] for r in reads]
        state_err = max(state_err, state_error(torch, prog, ref))
        readout_err = max(readout_err, max(abs(g - want) for g in got))
        del ref, prog
    return {"state_err": state_err, "readout_err": readout_err}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def percentile(values, q: float) -> float:
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", overrides=None,
             control: bool = False, log=None):
    """One run of ``workload``: (the result's fields, every number the
    comparison reads).  Under ``control`` the cell's control stands in the
    program's place (its ``control`` entry: the program in a lower matmul
    mode, or the reference in TF32).  ``device="cpu"`` and ``overrides``
    (configuration keys) are for the tests, which drive the harness at a
    tiny size on the CPU."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec, _entry, cfg, traffic, cell_file = load_cell(workload, overrides)
    import torch
    import quest_tpu_torch as qt
    from qtbench import trace as TR

    build_s = 0.0
    if device != "cpu":
        from quest_tpu_torch.ops import build
        build_s = build.build_kernels()
    ctl = cell_file["control"] if control else {}
    mode = ctl.get("matmul_precision", cfg["matmul_precision"])
    tf32_control = ctl.get("kind") == "reference_tf32"
    cell = Cell(qt, torch, cfg, traffic, seed, device, mode)

    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))
    t0 = time.perf_counter()
    cell.run_once()
    first_circuit_s = time.perf_counter() - t0
    cell.run_once()
    sync()
    setup_s = time.perf_counter() - t_start

    prof = TR.profiler() if trace else None
    if prof is not None:
        prof.start()
    lat, reads, gate_s = [], [], 0.0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        out, dt, tg = cell.run_once()
        lat.append(dt)
        reads.append(out)
        gate_s += tg
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - w0
    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    width = max(cell.batch, 1)
    circuits = len(lat) * width

    e2e = {
        "circuits_per_s": circuits / window_s,
        "circuit_p95_ms": percentile(lat, 95.0) * 1e3,
        "peak_mem_gib": peak / float(1 << 30),
        "setup_s": setup_s,
    }
    result = {"correct": False, "attempted": circuits, "failed": 0}
    log(f"qtbench: {workload} seed {seed}: {len(lat)} circuits in "
        f"{window_s:.3f} s, setup {setup_s:.3f} s (build {build_s:.3f} s, "
        f"first circuit {first_circuit_s:.3f} s), peak {peak} bytes")
    tr = None
    if trace:
        tr = TR.read(prof, window_s)
        del prof
        num_amps = width << cell.n
        costs = window_launch_costs(cell.program_plan(), num_amps)
        ctx = SimpleNamespace(
            circuits=circuits, drains=len(lat), trace=tr,
            gate_calls_s=gate_s, first_circuit_s=first_circuit_s,
            window_costs=costs, num_amps=num_amps,
            port_kernels=TR.port_kernel_functions(
                Path(qt.__file__).resolve().parent),
            log=log)
        values = {}
        for m in cell_metrics(spec, "per_layer", workload):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
            v = reader.read(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    else:
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell_metrics(spec, "end_to_end", workload)}
    result["device"] = device_info(torch, device, peak)
    if tr is not None:
        result["device"]["busy_s"] = TR.busy_s(tr)
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": TR.top_device_ops(tr),
                               "idle_gaps": TR.idle_gaps(tr)}

    # the comparison, once the window has closed and the peak is read
    finals = cell.final_states()
    cell.free_inputs()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    checks = compare(torch, cell, reads, finals, tf32_control=tf32_control)
    limits = cell_file["limits"]
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    result["correct"] = all(checks[k] <= limits[k] for k in limits)
    del finals, cell
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return result, checks


def device_info(torch, device: str, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}
