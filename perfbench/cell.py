"""One run of one cell: the program set up from the seed, warmed up, driven
for the window, then checked against the reference.

The entry and the objects are those the serve CLI builds
(`repro_torch.launch.serve.serve_requests`): `ExecutorEngine` over
`DisaggregatedExecutor` on the fused path, round-robin placement, a
`LengthAwareBatcher` with its inflection at half the cap.  The harness only
submits requests, wraps the executor's completion hook (`on_complete`) to
keep each finished request's last hidden row, and reads the executor's log
and host-sync counter.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import readers, traffic_gen, yardstick
from perfbench.tracing import Tracer

# ModelConfig fields that a configuration's "model" object fixes
MODEL_FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "vocab_size", "num_experts", "top_k", "moe_d_ff",
                "num_shared_experts", "qk_norm", "rope_theta", "norm_eps",
                "router_renorm", "act", "tie_embeddings")


def port_config(m: dict, exact: bool = True):
    """The port's ModelConfig for the model `m` describes: the registry
    entry with its depth (and dtype) set.  With `exact`, every other field
    `m` states must already be the registry's, so the yardstick counts the
    model that runs; without, `m`'s fields replace the registry's (a small
    model for the CPU tests)."""
    from repro_torch.configs import get_config
    from perfbench.weights import DTYPES
    cfg = get_config(m["registry"])
    cfg = cfg.replace(num_layers=m["num_layers"], dtype=DTYPES[m["dtype"]])
    if not exact:
        return cfg.replace(**{k: m[k] for k in MODEL_FIELDS})
    wrong = {k: (getattr(cfg, k), m[k]) for k in MODEL_FIELDS
             if getattr(cfg, k) != m[k]}
    if wrong:
        raise ValueError(f"the port's {m['registry']} differs from the "
                         f"configuration file: {wrong}")
    return cfg


@dataclasses.dataclass
class Record:
    """What a window leaves for the metric readers."""
    model: dict
    window_s: float
    jobs: List[dict]  # jobs completed in the window
    results: List[dict]  # requests due (open) or completed (closed) in it
    log: List[tuple]  # the executor's log events of the window
    host_syncs: int
    trace: Optional[dict]  # tracing.reduce_trace of the window, if traced
    peak: dict  # yardstick peak of the card


class _Hook:
    """Wraps the executor's completion hook: lets the engine finish the job,
    keeps each request's last hidden row and the job's shape and times, and
    tells the traffic driver."""

    def __init__(self, engine, on_done):
        self.inner = engine._on_job_done
        self.on_done = on_done
        self.lock = threading.Lock()
        self.jobs: List[dict] = []  # guarded_by: lock
        self.last_rows: Dict[int, torch.Tensor] = {}  # guarded_by: lock

    def __call__(self, job):
        self.inner(job)
        reqs = job.meta or []
        rows = {}
        if job.result is not None and reqs:
            pos = torch.as_tensor(np.asarray(job.lengths, np.int64) - 1,
                                  device=job.result.device)
            last = job.result[torch.arange(len(reqs),
                                           device=job.result.device), pos]
            rows = {r.rid: last[i].clone() for i, r in enumerate(reqs)}
        rec = {"lengths": list(job.lengths or []),
               "shape": tuple(np.asarray(job.tokens).shape),
               "t_finished": job.t_finished, "rids": [r.rid for r in reqs]}
        with self.lock:
            self.jobs.append(rec)
            self.last_rows.update(rows)
        self.on_done(job, rec)


def _jax_loaded() -> List[str]:
    import sys
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    return sorted({n.split(".")[0] for n in list(sys.modules)} & banned)


class Run:
    """Set-up, window and teardown of one cell run."""

    def __init__(self, plan, seed: int, seconds: float, trace: bool,
                 device, t_process: float, model: Optional[dict] = None,
                 exact: bool = True, build_dir=None):
        from repro_torch.core.engine import ExecutorEngine
        from repro_torch.core.executor import DisaggregatedExecutor
        from repro_torch.core.scheduler import LengthAwareBatcher
        from repro_torch.core.trace import TraceClock
        from repro_torch.kernels.super_gmm.ops import round_capacity
        from perfbench.weights import make_params

        self.plan, self.seed, self.seconds = plan, seed, float(seconds)
        self.t_process = t_process
        self.device = torch.device(device)
        self.m = dict(model if model is not None else plan.config["model"])
        self.mix = plan.traffic
        self.cfg = port_config(self.m, exact=exact)
        self.tracer = Tracer(trace and self.device.type == "cuda", build_dir)
        self.params = make_params(self.m, seed, self.device)
        mix = self.mix
        cap = int(mix["batch_cap"])
        self.ex = DisaggregatedExecutor(
            self.params, self.cfg, D=mix["D"], E=mix["E"],
            idle_backoff=0.05, moe_path="fused",
            moe_batch_window=mix["moe_batch_window"], device=self.device)
        # capacity buckets up to twice a full batch's mean rows per expert
        longest = max(traffic_gen.length_set(mix["lengths"]))
        per_batch = max(cap // 2, longest)
        rows = 2 * per_batch * self.m["top_k"] // self.m["num_experts"]
        self.ex.prewarm_buckets(round_capacity(max(rows, 1)))
        self.engine = ExecutorEngine(
            self.ex, clock=TraceClock(speed=1.0),
            batcher=LengthAwareBatcher(
                inflection=max(cap // 2, 1), max_tokens=cap,
                exclusive_cutoff=1 << 30,
                max_wait=mix["batcher_max_wait_s"]),
            token_seed=seed)
        self.hook = _Hook(self.engine, self._done)
        self.ex.on_complete = self.hook
        self.clock = self.engine.clock
        self._lengths = traffic_gen.lengths(mix["lengths"], 1 << 14, seed)
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._tokens: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ requests
    def _submit(self, arrival: float, client: Optional[int] = None,
                length: Optional[int] = None):
        from repro_torch.core.trace import Request
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        n = length or self._lengths[rid % len(self._lengths)]
        toks = traffic_gen.tokens(self.seed, rid, n, self.m["vocab_size"])
        self._tokens[rid] = toks
        if client is not None:
            self._client_of[rid] = client
        self.engine.submit(Request(rid=rid, arrival=arrival, length=n), toks)
        return rid

    def _done(self, job, rec):
        drive = getattr(self, "_drive", None)
        if drive is not None:
            drive(job, rec)

    def _warm_shapes(self):
        """Serve once every batch shape the mix can form: for each prompt
        length, batches of 1 up to the number of prompts that reach the
        batcher's inflection, each submitted together and drained.  (A
        batch's first appearance loads kernels and sizes buffers.)"""
        cap = int(self.mix["batch_cap"])
        infl = max(cap // 2, 1)
        lengths = sorted(set(traffic_gen.length_set(self.mix["lengths"])))
        for n in lengths:
            for b in range(1, -(-infl // n) + 1):
                if b > 1 and b * n > cap:
                    break
                now = self.clock.now()
                for _ in range(b):
                    self._submit(now, length=n)
                self._polled += self.engine.drain(timeout=300)
                self._check()

    # ------------------------------------------------------------- closed
    def _closed(self):
        mix = self.mix
        self._client_of: Dict[int, int] = {}
        self._state = "warm"
        warm = threading.Event()
        self._t0 = None
        lock = threading.Lock()
        done_jobs = [0]

        def drive(job, rec):
            with lock:
                done_jobs[0] += 1
                if self._state == "warm" and \
                        done_jobs[0] >= mix["warmup_jobs"]:
                    self._state = "window"
                    self._t0 = rec["t_finished"]
                    warm.set()
                resubmit = self._state in ("warm", "window")
            if resubmit:
                now = self.clock.now()
                for rid in rec["rids"]:
                    self._submit(now, self._client_of.get(rid))

        self.engine.start()
        self._warm_shapes()
        self._drive = drive
        for c in range(mix["clients"]):
            self._submit(0.0, c)
        deadline = time.monotonic() + 300
        while not warm.wait(0.2):
            self._check()
            if time.monotonic() > deadline:
                raise RuntimeError("warm-up did not finish in 300 s")
        if self.tracer.enabled:
            self.tracer.start()
            self._t0 = self.clock.now()
        self.t_window = time.monotonic()
        t1 = self._t0 + self.seconds
        self.log_from = self._log_len()
        self.syncs_from = self._syncs()
        self._sleep_until(t1)
        self.trace = self.tracer.stop()
        with lock:
            self._state = "drain"
        self.log_to = self._log_len()
        self.syncs_to = self._syncs()
        self.t1 = t1
        try:
            self.all_results = self.engine.drain(
                timeout=mix["late_after_s"]) + self._polled
        except TimeoutError:
            self.all_results = self.engine.poll() + self._polled
        self._check()

    # --------------------------------------------------------------- open
    def _open(self):
        mix = self.mix
        self._drive = None
        self.engine.start()
        self._warm_shapes()
        for _ in range(mix["warmup_jobs"]):
            self._submit(self.clock.now())
        self._polled += self.engine.drain(timeout=300)
        self._check()
        # a traced run starts the profiler before the first arrival (its
        # start-up is slow): the traced window takes in the lead-in
        self.tracer.start()
        t_trace = self.clock.now()
        self.log_from = self._log_len()
        self.syncs_from = self._syncs()
        arrivals = traffic_gen.open_arrivals(mix, self.seed, self.seconds)
        base = self.clock.now() + 0.05
        self._t0 = base + float(mix["lead_s"])
        t1 = self._t0 + self.seconds
        self._due: List[int] = []
        self._arrival: Dict[int, float] = {}
        for a in arrivals:
            t = base + float(a)
            if t > t1:
                break
            rid = self._submit(t)
            self._arrival[rid] = t
            if t >= self._t0:
                self._due.append(rid)
        self._sleep_until(self._t0)
        self.t_window = time.monotonic()
        if not self.tracer.enabled:
            self.log_from = self._log_len()
            self.syncs_from = self._syncs()
        self._sleep_until(t1)
        self.trace = self.tracer.stop()
        if self.trace is not None:
            self._t0 = t_trace
        self.log_to = self._log_len()
        self.syncs_to = self._syncs()
        self.t1 = t1
        try:
            self.all_results = self.engine.drain(
                timeout=mix["late_after_s"]) + self._polled
        except TimeoutError:
            self.all_results = self.engine.poll() + self._polled
        self.t_waited = self.clock.now()
        self._check()

    # ------------------------------------------------------------- plumbing
    def _check(self):
        """Raise the first failure of the engine's or executor's threads."""
        self.engine._check_errors()

    def _sleep_until(self, t: float):
        while True:
            now = self.clock.now()
            if now >= t:
                return
            self._check()
            time.sleep(min(t - now, 0.05))

    def _log_len(self) -> int:
        with self.ex._log_lock:
            return len(self.ex.log)

    def _syncs(self) -> int:
        from repro_torch.kernels import _launch
        return _launch.host_syncs

    def window(self):
        """Warm up, measure, drain.  Sets the record's raw pieces."""
        self._polled: list = []
        if self.mix["loop"] == "closed":
            self._closed()
        elif self.mix["loop"] == "open":
            self._open()
        else:
            raise ValueError(f"loop {self.mix['loop']!r}")
        self.setup_s = self.t_window - self.t_process
        with self.ex._log_lock:
            self.log = list(self.ex.log[self.log_from:self.log_to])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.memory_peak = 0
        self.engine.close()
        self.loaded = _jax_loaded()

    def record(self) -> Record:
        t0, t1 = self._t0, self.t1
        jobs = [j for j in self.hook.jobs
                if j["t_finished"] is not None and t0 < j["t_finished"] <= t1]
        if self.mix["loop"] == "open":
            due = set(self._due)
            res = [r for r in self.all_results if r.rid in due]
        else:
            res = [r for r in self.all_results
                   if t0 < r.first_token_time <= t1]
        results = [{"rid": r.rid, "length": r.length, "arrival": r.arrival,
                    "first_token_time": r.first_token_time,
                    "status": r.status, "first_token": r.first_token,
                    "queue": r.decomposition.get("queue", 0.0)}
                   for r in res]
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        return Record(model=self.m, window_s=t1 - t0,
                      jobs=jobs, results=results, log=self.log,
                      host_syncs=self.syncs_to - self.syncs_from,
                      trace=self.trace, peak=yardstick.peak(name))

    # ----------------------------------------------------- end-to-end values
    def end_to_end(self, rec: Record) -> Dict[str, float]:
        out = {"setup_s": self.setup_s}
        if self.mix["loop"] == "closed":
            toks = sum(r["length"] for r in rec.results
                       if r["status"] == "ok")
            out["prefill_tokens_per_s"] = toks / self.seconds
        else:
            # a request that failed or never came back counts as later than
            # every other: as waiting until the end of the wait after the
            # window
            ok = {r["rid"]: r["first_token_time"] - r["arrival"]
                  for r in rec.results if r["status"] == "ok"}
            waited = [self.t_waited - self._arrival[r] for r in self._due]
            late = max(waited + list(ok.values()) + [0.0]) + 1.0
            xs = [ok.get(rid, late) for rid in self._due]
            for q in (50, 90, 95, 99):
                out[f"ttft_p{q}_s"] = readers.percentile(xs, q) if xs else None
        return out

    def free_program(self):
        """Drop the program's state; the weights stay for the reference."""
        self.ex.params = None
        self.ex = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def execute(plan, seed: int, seconds: float, trace: bool, device,
            t_process: float, model: Optional[dict] = None,
            exact: bool = True, build_dir=None, control: bool = False):
    """One run: set-up, window, check.  Returns (result, checks, record,
    extra); `result` is the contract's last line but for `checks`, which
    the caller appends last; `extra` holds every end-to-end value, the
    banned modules the process loaded, and with `control` the control's
    numbers on the same prompts."""
    from perfbench import check
    run = Run(plan, seed, seconds, trace, device, t_process, model=model,
              exact=exact, build_dir=build_dir)
    run.window()
    rec = run.record()
    e2e = run.end_to_end(rec)
    units = {m["name"]: m["unit"] for m in plan.end_to_end + plan.per_layer}
    if trace:
        values = {m["name"]: plan.readers[m["name"]](rec)
                  for m in plan.per_layer}
    else:
        values = {m["name"]: e2e.get(m["name"]) for m in plan.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]}
               for k, v in values.items() if v is not None}
    attempted = len(rec.results) if run.mix["loop"] == "closed" \
        else len(run._due)
    ok_rids = {r["rid"] for r in rec.results if r["status"] == "ok"}
    failed = attempted - len(ok_rids)
    extra = {"end_to_end": e2e, "loaded": run.loaded}
    # the check: a sample of the window's served requests vs the reference
    picks = check.sample(rec.results, int(run.mix["check_requests"]), seed)
    served = {r["rid"]: r["first_token"] for r in rec.results}
    rows = torch.stack([run.hook.last_rows[r] for r in picks]) \
        if picks else None
    run.free_program()
    if rows is None:
        correct, checks = check.judge({}, plan.limits)
    else:
        ref_rows = check.reference_rows(run.m, run.params,
                                        [run._tokens[r] for r in picks],
                                        run.device)
        vals = check.numbers(run.params, rows, [served[r] for r in picks],
                             ref_rows)
        correct, checks = check.judge(vals, plan.limits)
        extra["values"] = vals
        if control:
            extra["control"] = check.control_numbers(
                run.m, run.params, [run._tokens[r] for r in picks],
                ref_rows, run.device)
    correct = correct and failed == 0
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(run.device)
           if run.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        from perfbench.tracing import breakdown
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["span_s"]
        result["breakdown"] = breakdown(rec.trace)
    run.params = run.hook = None  # the weights go with this run
    return result, checks, rec, extra
