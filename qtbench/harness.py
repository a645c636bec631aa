"""One run of one cell: set-up, the measured window, the traced reading,
the comparison with the plain reference, and the result's line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``, the
file that ``BENCHMARK.json`` gives) and its traffic
(``traffic/<name>.json``); the configuration names its circuit family
(``circuits/<circuit>.py``), its register kind (``register``:
``statevec``, the default, or ``density``) and its plain reference
(``reference/<reference>.py``, ``statevec`` by default); the cell's own
file (``workloads/<cell>.json``) holds the limits of its comparison and
its control; each per-layer metric is ``metrics/<metric>.py``.  The
register is split over the cell's ``chips`` cards, and the reference over
the same cards.  Adding a cell, a mix or a metric adds files and entries
and edits none.

Every cell is a closed loop with one client: a circuit is the
re-initialisation of the register (or bank) made at set-up, the circuit's
calls through the public API under ``gateFusion``, and a read-out that
returns a float to the host (the circuit module's ``readout(cfg)``, a
QuEST name and its arguments, where it has one).  The next circuit starts
when the read-out has returned.  The calls are drawn once at set-up, or,
under a mix's ``"calls": "fresh"``, anew for every circuit from (seed,
circuit), between circuits.
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

import numpy as np

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
    from the seed at set-up.  ``devices`` (tests and probes) lists the
    shards' devices; else a cell on the CPU has one shard there and a cell
    on cards one shard on each of its ``chips`` cards."""

    def __init__(self, qt, torch, cfg, traffic, seed: int, device: str,
                 matmul_precision: str, chips: int = 1, devices=None):
        from quest_tpu_torch.ops import fused

        self.qt, self.torch = qt, torch
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.n = int(cfg["num_qubits"])
        self.batch = int(traffic.get("batch", 0))
        qt.set_precision(int(cfg["quest_precision"]))
        fused.set_matmul_precision(matmul_precision)
        if devices is not None:
            self.env = qt.createQuESTEnv(devices=devices)
        elif device == "cpu":
            self.env = qt.createQuESTEnv(device="cpu")
        else:
            self.env = qt.createQuESTEnv(num_devices=chips)
        self.reference = load_reference(cfg.get("reference", "statevec"))
        self.circuit = load_module(BENCH / "circuits"
                                   / f"{cfg['circuit']}.py")
        calls = traffic.get("calls", "once")
        if calls not in ("once", "fresh"):
            raise ValueError(f"unknown calls {calls!r}")
        self.fresh = calls == "fresh"
        self.drawn = 0
        self.draw(self.seed_of(0))
        register = cfg.get("register", "statevec")
        if self.batch:
            self.q = qt.createBatchedQureg(self.n, self.env, self.batch)
        elif register == "statevec":
            self.q = qt.createQureg(self.n, self.env)
        elif register == "density":
            self.q = qt.createDensityQureg(self.n, self.env)
        else:
            raise ValueError(f"unknown register {register!r}")
        self.state_qubits = self.q.num_qubits_in_state_vec
        self.shard_devices = (list(self.env.devices) if self.q.is_sharded
                              else [self.q.device])
        if hasattr(self.circuit, "readout"):
            self.readout_name, self.readout_args = self.circuit.readout(cfg)
        elif self.batch:
            z = [[0] * (self.n - 1) + [3]]
            self.readout_name, self.readout_args = (
                "calcExpecPauliSumBatched", (z, [1.0]))
        else:
            self.readout_name, self.readout_args = (
                "calcProbOfOutcome", (self.n - 1, 0))
        self.readout_fn = getattr(qt, self.readout_name)
        # before the window: the reference has a form of every call
        self.reference.check(self.calls if not self.batch
                             else self.element_calls[0],
                             self.readout_name, len(self.shard_devices))
        self.source = None
        if cfg["init"] == "random":
            if register != "statevec":
                raise ValueError("init 'random' draws a state vector")
            shards, self.norm = random_shards(
                torch, self.state_qubits, seed, self.shard_devices)
            self.source = qt.createQureg(self.n, self.env)
            if self.q.is_sharded:
                from quest_tpu_torch.parallel.mesh import ShardedAmps

                self.source.amps = ShardedAmps(self.env.mesh, shards)
            else:
                self.source.amps = shards[0]
            del shards
        elif cfg["init"] != "zero":
            raise ValueError(f"unknown init {cfg['init']!r}")

    def seed_of(self, circuit: int):
        """The seed circuit ``circuit``'s calls are drawn from: the run's
        seed, or (seed, circuit) where every circuit draws anew."""
        return [int(self.seed), int(circuit)] if self.fresh else self.seed

    def draw(self, seed) -> None:
        """The circuit's calls (of a bank, and each element's) from
        ``seed``, resolved to the API's functions."""
        if self.batch:
            self.calls, self.element_calls = self.circuit.bank_calls(
                self.cfg, seed, self.batch)
        else:
            # a mix may name one of the circuit's routes (its other ways
            # of writing the same circuit); the circuit's own default else
            route = ({"route": self.traffic["route"]}
                     if "route" in self.traffic else {})
            self.calls = self.circuit.register_calls(self.cfg, seed,
                                                     **route)
            self.element_calls = [self.calls]
        self.resolved = [(getattr(self.qt, name), args)
                         for name, args in self.calls]

    def next_circuit(self) -> None:
        """Before every circuit after the first: where every circuit
        draws anew, the next circuit's calls."""
        if self.fresh:
            self.drawn += 1
            self.draw(self.seed_of(self.drawn))

    def init(self) -> None:
        if self.source is None:
            self.qt.initZeroState(self.q)
        else:
            self.qt.cloneQureg(self.q, self.source)

    def readout(self):
        """The cell's read-out: by default P(top qubit = 0) of the
        register, and of a bank each element's <Z> of the top qubit (= 2 P
        - 1) through the bank's API."""
        value = self.readout_fn(self.q, *self.readout_args)
        if self.batch:
            return [float(v) for v in value]
        return [float(value)]

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
        """The register's (or each bank element's) final state as a list
        of (first global index, (2, 2^m) float32 shard) on the device: one
        chunk at index 0, the register's own tensor, on one shard; the
        shards of a split register in order."""
        amps = self.q.amps
        if self.q.is_sharded:
            m = self.state_qubits - self.q.shard_bits
            parts = [(c << m, sh) for c, sh in enumerate(amps.shards)]
        else:
            parts = [(0, amps)]
        if not self.batch:
            return [parts]
        return [[(start, sh[b]) for start, sh in parts]
                for b in range(self.batch)]

    def free_inputs(self) -> None:
        if self.source is not None:
            self.qt.destroyQureg(self.source, self.env)
            self.source = None


def load_reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    path = BENCH / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"the configuration's reference {name!r}: no file "
            f"{path.relative_to(ROOT)}")
    return load_module(path)


def random_state(torch, n: int, seed: int, device):
    """A normalised random state of 2^n amplitudes, (2, 2^n) float32,
    made on ``device`` from ``seed``."""
    x = _draw(torch, n, seed, device)
    return x.div_(math.sqrt(_sum_sq(torch, x)))


def _draw(torch, n: int, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn((2, 1 << n), generator=gen, device=device,
                       dtype=torch.float32)


def _sum_sq(torch, x, block: int = 1 << 24) -> float:
    flat = x.view(-1)
    return sum(float(torch.sum(flat[s:s + block].double() ** 2))
               for s in range(0, flat.numel(), block))


def shard_seed(seed: int, shard: int) -> int:
    """The generator seed of shard ``shard`` of a split random state,
    from the pair (seed, shard)."""
    state = np.random.SeedSequence([int(seed), int(shard)])
    return int(state.generate_state(1, np.uint64)[0])


def random_shards(torch, n: int, seed: int, devices):
    """(shards, norm): a normalised random state of 2^n amplitudes split
    over len(devices) shards, shard c a (2, 2^m) float32 tensor on
    ``devices[c]`` drawn from (seed, c) and divided by ``norm``, the norm
    of the whole draw.  One shard is ``random_state`` itself."""
    if len(devices) == 1:
        x = random_state(torch, n, seed, devices[0])
        return [x], None
    m = n - (len(devices).bit_length() - 1)
    shards = [_draw(torch, m, shard_seed(seed, c), dev)
              for c, dev in enumerate(devices)]
    norm = math.sqrt(sum(_sum_sq(torch, x) for x in shards))
    for x in shards:
        x.div_(norm)
    return shards, norm


def random_shard(torch, n: int, seed: int, devices, shard: int, norm):
    """Shard ``shard`` of ``random_shards``' draw, drawn again alone."""
    if len(devices) == 1:
        return random_state(torch, n, seed, devices[0])
    m = n - (len(devices).bit_length() - 1)
    return _draw(torch, m, shard_seed(seed, shard), devices[shard]).div_(
        norm)


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
    for the TF32 control) from the inputs alone, as the reference
    module's chunks: one on each of the program's shard devices."""
    R = cell_like.reference
    devices = cell_like.shard_devices
    dtype = torch.complex64 if tf32 else torch.complex128
    n = cell_like.state_qubits
    reals = None
    if cell_like.cfg["init"] == "random":
        reals = (random_shard(torch, n, cell_like.seed, devices, c,
                              cell_like.norm)
                 for c in range(len(devices)))
    chunks = R.initial_chunks(n, devices, dtype, reals)
    R.apply_calls(chunks, cell_like.element_calls[element], tf32=tf32)
    return chunks


def state_error(torch, prog, ref, block: int = 1 << 24) -> float:
    """||prog - ref|| / ||ref||, prog a list of (first global index, (2,
    2^m) real shard), ref the reference's complex chunks in the same
    order, summed in float64 in blocks, chunk by chunk on each chunk's
    device."""
    num = den = 0.0
    for c, ((start, p), r) in enumerate(zip(prog, ref, strict=True)):
        if start != c * r.numel():
            raise ValueError(f"shard {c} starts at {start}, not at chunk "
                             f"{c}'s first index")
        for s in range(0, r.numel(), block):
            rb = r[s:s + block].to(torch.complex128)
            pb = torch.complex(p[0, s:s + block].double(),
                               p[1, s:s + block].double())
            num += float(torch.sum(torch.abs(pb - rb) ** 2))
            den += float(torch.sum(torch.abs(rb) ** 2))
            del rb, pb
    return math.sqrt(num / den)


def readout_of(cell_like, chunks) -> float:
    """The read-out the cell's circuits return, of a reference state."""
    return cell_like.reference.readout(chunks, cell_like.readout_name,
                                       cell_like.readout_args)


def compare(torch, cell, reads, finals, tf32_control: bool) -> dict:
    """The numbers compared: ``state_err``, the largest relative distance
    of a final state (``finals``) from the reference's, and
    ``readout_err``, the largest gap of any read-out of the window (the
    last circuit's alone where every circuit draws anew) from the
    reference's.  With ``tf32_control`` the reference in TF32 stands in
    the program's place."""
    if cell.fresh:
        reads = reads[-1:]
    state_err, readout_err = 0.0, 0.0
    for b in range(max(cell.batch, 1)):
        ref = reference_states(torch, cell, b)
        want = readout_of(cell, ref)
        if tf32_control:
            low = reference_states(torch, cell, b, tf32=True)
            prog = [(c * low[c].numel(), torch.stack([x.real, x.imag]))
                    for c, x in enumerate(low)]
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
             t_start: float, device: str = "cuda", devices=None,
             overrides=None, traffic_overrides=None, control: bool = False,
             log=None):
    """One run of ``workload``: (the result's fields, every number the
    comparison reads).  Under ``control`` the cell's control stands in the
    program's place (its ``control`` entry: the program in a lower matmul
    mode, or the reference in TF32).  ``device="cpu"``, ``devices`` (the
    shards' devices, such as ``["cpu"] * 4`` or ``["cuda:0"] * 4``),
    ``overrides`` (configuration keys) and ``traffic_overrides`` (keys of
    the mix) are for the tests and probes, which drive the harness at a
    tiny size on the CPU or split a register over one card."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec, entry, cfg, traffic, cell_file = load_cell(workload, overrides)
    traffic.update(traffic_overrides or {})
    import torch
    import quest_tpu_torch as qt
    from qtbench import trace as TR

    build_s = 0.0
    if any(torch.device(d).type == "cuda" for d in devices or [device]):
        from quest_tpu_torch.ops import build
        build_s = build.build_kernels()
    ctl = cell_file["control"] if control else {}
    mode = ctl.get("matmul_precision", cfg["matmul_precision"])
    tf32_control = ctl.get("kind") == "reference_tf32"
    cell = Cell(qt, torch, cfg, traffic, seed, device, mode,
                chips=int(entry["chips"]), devices=devices)
    cards = sorted({d for d in cell.env.devices if d.type == "cuda"},
                   key=lambda d: d.index or 0)

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    t0 = time.perf_counter()
    cell.run_once()
    first_circuit_s = time.perf_counter() - t0
    cell.next_circuit()
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
        cell.next_circuit()
        out, dt, tg = cell.run_once()
        lat.append(dt)
        reads.append(out)
        gate_s += tg
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - w0
    if prof is not None:
        prof.stop()
    peaks = {str(card): torch.cuda.max_memory_allocated(card)
             for card in cards}
    peak = max(peaks.values(), default=0)
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
        f"first circuit {first_circuit_s:.3f} s), peak {peak} bytes "
        f"({len(cell.shard_devices)} shards on {peaks or 'the cpu'})")
    tr = None
    if trace:
        tr = TR.read(prof, window_s)
        del prof
        # the amplitudes one window launch covers: one shard's
        num_amps = width << (cell.state_qubits - cell.q.shard_bits)
        costs = window_launch_costs(cell.program_plan(), num_amps)
        ctx = SimpleNamespace(
            circuits=circuits, drains=len(lat), trace=tr,
            gate_calls_s=gate_s, first_circuit_s=first_circuit_s,
            window_costs=costs, num_amps=num_amps,
            shards=len(cell.shard_devices),
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
    result["device"] = device_info(torch, cards, peaks)
    if tr is not None:
        by_card = {str(card): TR.busy_s(tr, card.index or 0)
                   for card in cards}
        result["device"]["busy_s"] = (sum(by_card.values()) / len(by_card)
                                      if by_card else TR.busy_s(tr))
        result["device"]["window_s"] = window_s
        result["device"]["busy_s_by_card"] = by_card
        result["breakdown"] = {"device_ops": TR.top_device_ops(tr),
                               "idle_gaps": TR.idle_gaps(tr)}

    # the comparison, once the window has closed and the peak is read
    finals = cell.final_states()
    cell.free_inputs()
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = compare(torch, cell, reads, finals, tf32_control=tf32_control)
    log(f"qtbench: the comparison took {time.perf_counter() - t0:.3f} s")
    limits = cell_file["limits"]
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    result["correct"] = all(checks[k] <= limits[k] for k in limits)
    del finals, cell
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    return result, checks


def device_info(torch, cards, peaks: dict) -> dict:
    """The result's ``device``: the cards the run used (none: the CPU),
    and the peak of the fullest."""
    if not cards:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
            "count": len(cards), "memory_peak_bytes": max(peaks.values()),
            "memory_peak_bytes_by_card": peaks}
