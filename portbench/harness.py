"""One run of one cell: inputs from the seed, set-up with a warm-up, the
measured window, the check of every archive the window wrote, and the
metrics read by each metric's own reader.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``BENCHMARK.json`` names the configuration file;
``traffic/<traffic>.json`` names the operation (``ops/<operation>.py``);
the configuration names its generator (``gen/<generator>.py``); each
metric is read by ``metrics/<metric>.py``. Adding a cell adds files.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import roofline
from portbench import tracing
from portbench.inputs import N_CODE, rng_for, write_fasta
from portbench.reference import discovery, judge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
# top-level module names no run may load: JAX and the package the port
# was made from (compared whole, so the port's own name passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "agc_tpu")
PROGRAM = "agc_tpu_torch.core.compressor"


class NoCard(RuntimeError):
    pass


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    if not NAME.match(name):
        raise LookupError(f"{name!r} is not a valid {kind} name")
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} named {name!r} ({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, bench: dict | None = None) -> Spec:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic and the metrics it reports."""
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise LookupError(f"no workload named {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[cell["config"]]["file"])
    if not NAME.match(cell["traffic"]):
        raise LookupError(f"{cell['traffic']!r} is not a valid traffic name")
    traffic_file = HERE / "traffic" / f"{cell['traffic']}.json"
    if not traffic_file.is_file():
        raise LookupError(f"no traffic named {cell['traffic']!r}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Spec(name, cell["chips"], config, read_json(traffic_file), e2e, layer)


@dataclass
class Cell:
    """What an operation's driver works with."""

    spec: Spec
    inputs: object
    workdir: str
    device: str
    program: object
    verbosity: int
    state: dict = field(default_factory=dict)

    def params(self):
        return self.program.CompressorParams(**self.spec.config["params"],
                                             verbosity=self.verbosity)


@dataclass
class Run:
    """What a metric's reader reads."""

    spec: Spec
    ops: list  # the window's completed operations
    window_s: float
    setup_s: float
    trace: tracing.Trace | None = None
    least_s: float | None = None

    @property
    def symbols(self) -> int:
        return sum(op["symbols"] for op in self.ops)

    def stage_s_per_gbase(self, *stages: str) -> float | None:
        """Seconds the program's stage timers give ``stages`` over the
        window's operations, per Gbase of their input; None when no
        operation timed any of them."""
        timed = [op for op in self.ops if op["timers"] is not None
                 and any(s in op["timers"] for s in stages)]
        if not timed:
            return None
        seconds = sum(op["timers"].get(s, 0.0) for op in timed for s in stages)
        return seconds / (sum(op["symbols"] for op in timed) / 1e9)


def scrub_env(env: dict) -> None:
    """Clear every setting of the program the configuration does not make,
    set the ones it does, and pin the build caches inside the checkout."""
    for key in [k for k in os.environ if k.startswith("AGC_TPU_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in env.items()})
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def program():
    """The program's entry module, which must be the checkout's own."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    module = importlib.import_module(PROGRAM)
    if ROOT not in Path(module.__file__).resolve().parents:
        raise ImportError(f"{PROGRAM} comes from {module.__file__}, not from {ROOT}")
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_check(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")
    return torch.cuda.get_device_name(0)


def lose_n(inputs) -> None:
    """The control: the program is given its inputs with every N stored as
    A, as a store of two bits a base would keep them, and is judged against
    the true inputs."""
    seen = set()
    for s in [inputs.reference, *inputs.samples, *inputs.extra, *inputs.warmup]:
        if s.path not in seen:
            seen.add(s.path)
            write_fasta(s.path, [(h, np.where(c == N_CODE, 0, c)) for h, c in s.contigs])


def window(cell: Cell, driver, seconds: float, traced: bool):
    """Operations back to back for ``seconds``: the last one that starts in
    the window runs to its end. Returns (operations, window seconds,
    profiler or None)."""
    import torch

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cell.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    ops = []
    span = tracing.SPAN + cell.spec.traffic["operation"]
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while not ops or time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            with (torch.profiler.record_function(span) if traced
                  else contextlib.nullcontext()):
                try:
                    op = driver.run(cell, len(ops))
                    op["error"] = None
                except Exception as exc:  # counted as failed, the window goes on
                    op = {"error": repr(exc), "symbols": 0, "bytes": 0, "timers": None}
            op["wall_s"] = time.perf_counter() - start
            ops.append(op)
        t1 = time.perf_counter()
    return ops, t1 - t0, prof


def check_window(cell: Cell, ops: list, seed: int):
    """The compared numbers over every archive the window wrote (the worst
    of each), and the reference's discovery. Archives that hold the same
    parts are read in full once; each one's layout is checked."""
    p = cell.spec.config["params"]
    ref = discovery.discover([c for _, c in cell.inputs.reference.contigs],
                             p["kmer_length"], p["segment_size"])
    checks = dict.fromkeys(judge.LIMITS, 0)
    distinct = {}
    for op in ops:
        digest, unaccounted = judge.layout_only(op["path"])
        checks["bytes_unaccounted"] = max(checks["bytes_unaccounted"], unaccounted)
        distinct.setdefault(digest, op)
    for op in distinct.values():
        want = judge.expected_samples(op["expected"], p["concatenated_genomes"])
        names = [n for n, _ in want]
        n_cut = cell.spec.config.get("check", {}).get("cut_samples")
        if n_cut is None or n_cut >= len(names) - 1:
            picked = set(names)
        else:
            longest = max(want, key=lambda s: max(len(c) for _, c in s[1]))[0]
            drawn = rng_for(seed, 99).choice(names[1:], size=n_cut, replace=False)
            picked = {names[0], longest, *drawn.tolist()}
        got = judge.judge(op["path"], want, ref, p, picked.__contains__)
        checks = {k: max(checks[k], got[k]) for k in checks}
    return checks, ref, len(distinct)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run; returns the result object. ``device="cpu"`` runs the
    program's plain versions (tests); the benchmark's own runs pass
    ``cuda`` after ``card_check``."""
    t_start = time.perf_counter() if t_start is None else t_start
    scrub_env(spec.config.get("env", {}))
    prog = program()
    import torch

    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        gen = load("gen", spec.config["generator"])
        driver = load("ops", spec.traffic["operation"])
        gparams = {**spec.config["generator_params"], **spec.traffic.get("generator_params", {})}
        inputs = gen.make(gparams, seed, workdir, driver.extra_samples(spec.traffic))
        if control:
            lose_n(inputs)
        cell = Cell(spec, inputs, workdir, device, prog, verbosity=1 if traced else 0)
        driver.setup(cell)
        if device == "cuda":
            torch.cuda.synchronize()
        os.sync()  # the inputs' writeback does not run inside the window
        gc.collect()
        setup_s = time.perf_counter() - t_start

        ops, window_s, prof = window(cell, driver, seconds, traced)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        summary = None
        if prof is not None:
            summary = tracing.summarize(prof.events(), torch.autograd.DeviceType.CUDA,
                                        torch.autograd.DeviceType.CPU)
            del prof

        done = [op for op in ops if op["error"] is None]
        t_check = time.perf_counter()
        checks, ref, n_distinct = check_window(cell, done, seed)
        t_check = time.perf_counter() - t_check
        run = Run(spec, done, window_s, setup_s, summary)
        if traced:
            run.least_s = sum(roofline.least_seconds(ref if op["discovery"] else None,
                                                     op["sample_bases"]) for op in done)
        metrics = {}
        for m in (spec.per_layer if traced else spec.end_to_end):
            value = load("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        failed = len(ops) - len(done)
        print(f"cell {spec.name} seed {seed} window {window_s!r} s setup {setup_s!r} s")
        print(f"device {torch.cuda.get_device_name(0) if device == 'cuda' else device}; "
              f"{nvidia_smi() if device == 'cuda' else ''}; host cores {os.cpu_count()}")
        print("settings " + json.dumps({k: v for k, v in sorted(os.environ.items())
                                        if k.startswith("AGC_TPU_")}))
        for i, op in enumerate(ops):
            print(f"op {i}: {op['wall_s']!r} s, {op['symbols']} symbols, "
                  f"{op['bytes']} bytes" + (f", failed: {op['error']}" if op["error"] else ""))
        print(f"archives judged: {n_distinct} distinct of {len(done)}, in {t_check!r} s")
        if summary is not None:
            print(f"trace: busy {summary.busy_s!r} s, kernels {summary.kernel_s!r} s "
                  f"of {summary.window_s!r} s; least {run.least_s!r} s")

        result = {
            "correct": bool(done) and not failed
            and all(checks[k] <= lim for k, lim in judge.LIMITS.items()),
            "attempted": len(ops),
            "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                       "count": spec.chips, "memory_peak_bytes": peak},
        }
        if summary is not None:
            result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
            result["breakdown"] = {"device_ops": summary.device_ops,
                                   "idle_gaps": summary.idle_gaps}
        result["checks"] = {k: {"value": checks[k], "limit": lim}
                            for k, lim in judge.LIMITS.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
