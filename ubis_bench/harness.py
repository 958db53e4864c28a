"""One run of one cell: set-up, the measured window, the reference, the line.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (the entry's ``file``, whose
``engine`` names the ``repro_torch.api`` engine under test, ``ubis``
where it names none) and its traffic mix: ``traffic/<traffic>.json``,
the parameters that the general generator and step below read, or
``traffic/<traffic>.py``, a module whose ``PARAMS`` are those
parameters and which may define ``make_stream(config, traffic, steps,
seed, device)`` (the data, a :class:`stream.StreamData`) and
``step(driver, s, deadline, record)`` (one step of the window) in place
of the general ones.  Each metric the cell reports is read by
``metrics/<metric name>.py``, a module with ``read(run)`` that returns a
number, or None where it finds nothing to read.

A run, in order:

1. set-up: the stream from the seed (:mod:`stream`), the index through
   ``repro_torch.api.make_index("ubis", ...)``, the load (chunks of
   ``load.chunk`` inserts, each followed by ticks until the background
   is quiet, at most ``load.ticks_max``), then one warm-up step of the
   traffic at the window's own shapes;
2. the window: traffic steps until ``--seconds`` have passed (a step's
   updates always finish; no search batch is dispatched after the
   deadline, and those in flight are collected).  Each step inserts
   ``fresh`` vectors, deletes the ``deletes`` oldest, ticks until the
   background is quiet (at most ``ticks_max``), then searches each of the
   ``batches`` batches of the fixed query pool, ``depth`` in flight
   (``dispatch_search`` / ``collect_search``), the first of them even
   past the deadline.  Every step the id room holds (``max_ids``) is
   drawn before the window; a window that runs out of them is no
   result;
3. the program's peak memory is read and its state freed, then
   :mod:`reference` judges the window's answers;
4. the metrics are read and the line made (``run.py`` prints it once it
   has found no forbidden module loaded).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import reference, tracing
from .stream import derived_seed, make_stream

BENCH = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its files give it."""

    cell: dict
    config: dict
    traffic: dict
    metrics: list          # BENCHMARK.json entries: this cell's, by kind
    chips: int
    hooks: dict = dataclasses.field(default_factory=dict)   # traffic/*.py


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def _load_module(path: Path, prefix: str, name: str):
    mod_name = prefix + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traffic(name: str) -> tuple:
    """``traffic/<name>.json``'s parameters, or ``traffic/<name>.py``'s
    ``PARAMS`` with its ``make_stream`` and ``step`` where it has them."""
    path = BENCH / "traffic" / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text()), {}
    mod = _load_module(BENCH / "traffic" / f"{name}.py",
                       "ubis_bench_traffic_", name)
    hooks = {k: getattr(mod, k) for k in ("make_stream", "step")
             if hasattr(mod, k)}
    return dict(mod.PARAMS), hooks


def load_spec(root: Path, cell: str, trace: bool,
              overrides: Optional[dict] = None) -> Spec:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its configuration,
    traffic mix and the metrics it reports (the per-layer ones when
    ``trace``).  ``overrides``: {"config": {...}, "traffic": {...}},
    nested keys replaced (the CPU tests' small sizes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[cell]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic, hooks = load_traffic(w["traffic"])
    for key, over in (overrides or {}).items():
        target = config if key == "config" else traffic
        for k, v in over.items():
            if isinstance(v, dict):
                target[k] = {**target[k], **v}
            else:
                target[k] = v
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if _reports(m, cell)]
    return Spec(cell=w, config=config, traffic=traffic, metrics=metrics,
                chips=int(w["chips"]), hooks=hooks)


def read_metric(name: str, run) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)``."""
    mod = _load_module(BENCH / "metrics" / f"{name}.py",
                       "ubis_bench_metric_", name)
    value = mod.read(run)
    return None if value is None else float(value)


def program_index(config: dict, seed_vectors: np.ndarray, device, seed: int):
    """The system under test: the configuration's ``repro_torch`` engine
    (``ubis`` where it names none)."""
    from repro_torch.api import make_index
    from repro_torch.core.types import UBISConfig
    if device.type == "cuda":
        from repro_torch.kernels import _nvcc
        _nvcc.build()            # every kernel built before the window
    return make_index(config.get("engine", "ubis"),
                      UBISConfig(**config["index"]), seed_vectors,
                      device=device, seed=derived_seed(seed, "index"),
                      **config["driver"])


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""

    spec: Spec
    setup_s: float = 0.0
    window_s: float = 0.0
    searches: list = dataclasses.field(default_factory=list)
    steps: int = 0
    inserts: int = 0
    acked: int = 0
    rejected: int = 0
    deletes: int = 0
    deleted: int = 0
    blocked: int = 0
    ticks: int = 0
    stats: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    trace: Optional[tracing.Trace] = None

    @property
    def index(self) -> dict:
        return self.spec.config["index"]


def _quiet(r) -> bool:
    return not (r.executed or r.marked or r.spilled or r.promoted
                or getattr(r, "migrated", 0))


class Driver:
    """Drives one index through the traffic, keeping the reference's
    record: which ids were live at each search, and every answer."""

    def __init__(self, idx, data, spec: Spec, run: Run, span, traced: bool):
        self.idx, self.data, self.spec, self.run = idx, data, spec, run
        self.span, self.traced = span, traced
        self.lo, self.hi = 0, data.n          # live ids: [lo, hi)
        self.k = int(spec.config["k"])

    def step(self, s: int, deadline: float, record: bool) -> None:
        """Step ``s``: the traffic module's ``step`` where it has one."""
        hook = self.spec.hooks.get("step", Driver.general_step)
        hook(self, s, deadline, record)

    def general_step(self, s: int, deadline: float, record: bool) -> None:
        t, run = self.spec.traffic, self.run
        ids = self.data.step_ids(s)
        with self.span("insert"):
            r = self.idx.insert(self.data.step_vectors(s), ids)
        self.hi = int(ids[-1]) + 1
        with self.span("delete"):
            d = self.idx.delete(np.arange(self.lo, self.lo + t["deletes"]))
        self.lo += t["deletes"]
        ticks = 0
        for _ in range(int(t["ticks_max"])):
            with self.span("tick"):
                tr = self.idx.tick()
            ticks += 1
            if _quiet(tr):
                break
        if record:
            run.steps += 1
            run.inserts += len(ids)
            run.acked += r.accepted + r.cached
            run.rejected += r.rejected
            run.deletes += t["deletes"]
            run.deleted += d.deleted
            run.blocked += d.blocked
            run.ticks += ticks
        self.search(deadline, record)

    def search(self, deadline: float, record: bool) -> None:
        t = self.spec.traffic
        inflight = collections.deque()
        for b in range(int(t["batches"])):
            if b and record and time.perf_counter() >= deadline:
                break
            t0 = time.perf_counter()
            try:
                with self.span("search.dispatch"):
                    h = self.idx.dispatch_search(self.data.queries[b],
                                                 self.k)
            except Exception:
                say(traceback.format_exc())
                h = None
            inflight.append((h, t0, b))
            if len(inflight) >= int(t["depth"]):
                self._collect(inflight.popleft(), record)
        while inflight:
            self._collect(inflight.popleft(), record)

    def _collect(self, item, record: bool) -> None:
        h, t0, qset = item
        res = None
        if h is not None:
            try:
                with self.span("search.collect"):
                    res = self.idx.collect_search(h)
            except Exception:
                say(traceback.format_exc())
        t1 = time.perf_counter()
        if not record:
            return
        probe = getattr(h, "probe", None)
        self.run.searches.append(dict(
            lo=self.lo, hi=self.hi, qset=qset,
            queries=self.data.queries.shape[1],
            ids=None if res is None else np.asarray(res.ids),
            scores=None if res is None else np.asarray(res.scores),
            latency=t1 - t0,
            probe=(probe.cpu().numpy() if self.traced and res is not None
                   and probe is not None else None)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steps_for(spec: Spec) -> int:
    """Steps to draw, the warm-up's with them: every step whose ids the
    id room (``max_ids``) holds."""
    t, c = spec.traffic, spec.config
    return (int(c["index"]["max_ids"]) - int(c["data"]["n"])) // int(
        t["fresh"])


def default_stream(config: dict, traffic: dict, steps: int, seed: int,
                   device):
    """The general generator (:func:`stream.make_stream`)."""
    return make_stream(config["data"], int(config["index"]["dim"]),
                       int(traffic["fresh"]), steps, int(traffic["batches"]),
                       int(traffic["queries"]), seed, device)


def host_ms() -> float:
    """Milliseconds the host takes for a fixed piece of Python and numpy
    work: printed beside each run, to tell a slower host from a slower
    program."""
    t0 = time.perf_counter()
    sum(i * i for i in range(300_000))
    np.sort(np.random.default_rng(0).random(1 << 18))
    return (time.perf_counter() - t0) * 1e3


def power_text() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(spec: Spec, *, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             index_factory: Callable = program_index) -> dict:
    """One run of ``spec``'s cell; returns the result line as a dict."""
    dev = torch.device(device)
    cfg, t = spec.config, spec.traffic
    run = Run(spec=spec)
    steps = steps_for(spec)
    data = spec.hooks.get("make_stream", default_stream)(cfg, t, steps, seed,
                                                          dev)
    say(f"data: {data.n} + {steps} x {data.fresh} vectors, "
        f"{data.queries.shape[0]} x {data.queries.shape[1]} queries, "
        f"{time.perf_counter() - t_start:.1f} s since start")
    idx = index_factory(cfg, data.vectors[:data.n], dev, seed)
    _sync(dev)
    say(f"built: {time.perf_counter() - t_start:.1f} s since start")
    chunk, tmax = int(cfg["load"]["chunk"]), int(cfg["load"]["ticks_max"])
    ticks = 0
    for off in range(0, data.n, chunk):
        end = min(data.n, off + chunk)
        idx.insert(data.vectors[off:end], np.arange(off, end))
        for _ in range(tmax):
            ticks += 1
            if _quiet(idx.tick()):
                break
    say(f"loaded {data.n} in {time.perf_counter() - t_start:.1f} s since "
        f"start, {ticks} ticks")
    # one step of the traffic at the window's shapes, not measured
    driver = Driver(idx, data, spec, run, tracing.spans(False), False)
    driver.step(0, math.inf, record=False)
    _sync(dev)
    host = host_ms()
    say(f"warmed up: {time.perf_counter() - t_start:.1f} s since start; "
        f"host {host:.1f} ms for the fixed work")
    stats0 = dict(getattr(idx, "stats", {}))

    driver.span, driver.traced = tracing.spans(trace), trace
    with tracing.profiled(trace, dev.type) as traced:
        with driver.span("window"):
            t0 = time.perf_counter()
            run.setup_s = t0 - t_start
            deadline = t0 + seconds
            ends = []
            for s in range(1, steps):
                if time.perf_counter() >= deadline:
                    break
                driver.step(s, deadline, record=True)
                ends.append(time.perf_counter() - t0)
            _sync(dev)
            run.window_s = time.perf_counter() - t0
    quarters = np.histogram(ends, bins=4, range=(0.0, run.window_s))[0]
    say(f"window: {run.steps} steps in {run.window_s:.2f} s, steps ended "
        f"by quarter {quarters.tolist()}")
    if run.window_s < seconds:
        say(f"refused: the {steps - 1} steps the id room holds ran out "
            f"after {run.window_s:.2f} s of the {seconds} s window")
        raise SystemExit(5)
    run.trace = traced.trace
    run.stats = {k: v - stats0.get(k, 0.0)
                 for k, v in getattr(idx, "stats", {}).items()}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    card = power_text() if dev.type == "cuda" else "cpu"
    del idx, driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on a sample of each batch's queries from the seed
    rng = np.random.default_rng(derived_seed(seed, "sample"))
    for b in run.searches:
        n = min(int(t["recall_sample"]), b["queries"])
        b["sample"] = np.sort(rng.choice(b["queries"], n, replace=False))
    t_ref = time.perf_counter()
    run.checks = reference.judge(data.vectors, data.queries, run.searches,
                                 int(cfg["k"]), dev, data.first_window_id())
    say(f"reference: {len(run.searches)} batches judged in "
        f"{time.perf_counter() - t_ref:.1f} s")
    limits = cfg["limits"]
    correct = reference.verdict(run.checks, limits)

    metrics = {}
    for m in spec.metrics:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lost_q = sum(b["queries"] for b in run.searches if b["ids"] is None)
    line = {
        "correct": bool(correct),
        "attempted": run.inserts + run.deletes + sum(
            b["queries"] for b in run.searches),
        "failed": run.rejected + run.blocked + lost_q,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": spec.chips if dev.type == "cuda" else 0,
            "memory_peak_bytes": int(peak)},
        "card": card,
        "window": {"steps": run.steps, "batches": len(run.searches),
                   "ticks": run.ticks, "seconds": run.window_s,
                   "host_ms": host},
    }
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s()
        line["device"]["window_s"] = run.trace.window_s or run.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {name: {"value": value, "limit": limits[name]}
                      for name, value in run.checks.items()}
    return line


def check_lines(line: dict) -> list:
    out = []
    for name, c in line["checks"].items():
        rel = ">=" if name in reference.AT_LEAST else "<="
        out.append(f"check {name}: {c['value']!r} (limit {rel} "
                   f"{c['limit']!r})")
    out.append(f"correct: {str(line['correct']).lower()}")
    return out
