"""The uops-as-a-service backend: coalescing, caching prediction service
plus a multi-worker asyncio front door.

:class:`PredictionService` is the in-process core. Requests submitted one at
a time are *coalesced*: a background worker drains the queue for a short
window and hands whole per-uarch groups to the vectorized
:class:`~repro_torch.service.batch_predictor.BatchPredictor`, so a burst of
single-block queries costs one array pass, not N predictor calls. Results
land in a **sharded** LRU cache (:class:`ShardedLRU` — N independent
locks) keyed by ``(model version, uarch, canonical block)`` — the
canonical form is operand-order-free, and including the registry's model
version means a hot reload implicitly invalidates every stale entry. Each
cache entry also carries the lazily-encoded binary response segment, so a
warm bulk wave on the binary wire is a bytes join.

:class:`PredictionServer` is the **asyncio front door**: one event loop
owns every connection, CPU work runs on a bounded worker pool behind an
:class:`AdmissionController` (typed ``Overloaded`` shed errors instead of
unbounded queueing), and the wire — length-prefixed binary or legacy
newline-JSON — is negotiated per connection by first-byte sniffing
(``protocol.py``). The PR-7 one-thread-per-connection server survives as
:class:`ThreadedPredictionServer` (the saturation bench's baseline).
Endpoints: predict, predict_batch, uarches, stats, metrics, reload,
validate, ping. Per-endpoint stats (request counts, error counts, cache
hit rate, p50/p99 latency, coalesced batch sizes, admission/shed
counters) are served by ``stats``.

Observability (see :mod:`repro_torch.obs`): every prediction request gets a
**trace id** (returned as ``trace_id`` in the response envelope and
attached to the request's spans, so a slow client request can be found in
a Perfetto trace); per-endpoint latency reservoirs are backed by
:class:`repro_torch.obs.metrics.Histogram` instruments (``metrics()`` returns
the canonical registry snapshot, ``stats()`` keeps the legacy shape);
``REPRO_ACCESS_LOG=path`` appends one JSON access record per request
(trace id, endpoint, batch size, cache hits, wall µs), and requests over
the ``REPRO_SLOW_REQUEST_US`` budget are logged at WARNING.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import queue
import socketserver
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Executor, Future

from repro_torch.core.isa import TEST_ISA
from repro_torch.core.predictor import UnknownInstructionError, missing_specs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs
from repro_torch.service import protocol
from repro_torch.service.batch_predictor import BatchPredictor
from repro_torch.service.registry import ModelRegistry

_LOG = logging.getLogger("repro_torch.service")

#: env knobs for the access log and the slow-request WARNING budget
ENV_ACCESS_LOG = "REPRO_ACCESS_LOG"
ENV_SLOW_US = "REPRO_SLOW_REQUEST_US"
#: size-based access-log rotation (keep-1 rollover to ``<path>.1``)
ENV_ACCESS_LOG_MAX = "REPRO_ACCESS_LOG_MAX_BYTES"
#: front-door sizing knobs
ENV_WORKERS = "REPRO_SERVER_WORKERS"
ENV_BUDGET_US = "REPRO_LATENCY_BUDGET_US"


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class LRUCache:
    """Thread-safe LRU mapping with hit/miss counters."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            try:
                val = self._d.pop(key)
            except KeyError:
                self.misses += 1
                return None
            self._d[key] = val
            self.hits += 1
            return val

    def get_many(self, keys) -> list:
        """One lock acquisition for a whole batch of lookups."""
        with self._lock:
            out = []
            for key in keys:
                try:
                    val = self._d.pop(key)
                except KeyError:
                    self.misses += 1
                    out.append(None)
                else:
                    self._d[key] = val
                    self.hits += 1
                    out.append(val)
            return out

    def put(self, key, val) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = val
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._d), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": round(self.hits / max(1, total), 4)}


class ShardedLRU:
    """N independent :class:`LRUCache` shards keyed by hash.

    Under concurrent front-door workers a single cache lock serializes
    every warm hit; sharding makes lock contention 1/N while keeping the
    exact LRU semantics per shard. :meth:`stats` keeps the legacy
    aggregate keys and adds a ``shards`` list with per-shard hit rates."""

    def __init__(self, capacity: int = 4096, shards: int = 8):
        shards = max(1, int(shards))
        per = max(1, -(-capacity // shards))  # ceil
        self.capacity = capacity
        self.shards = [LRUCache(per) for _ in range(shards)]
        self._n = shards

    def _shard(self, key) -> LRUCache:
        return self.shards[hash(key) % self._n]

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self.shards)

    @property
    def misses(self) -> int:
        return sum(s.misses for s in self.shards)

    def get(self, key):
        return self._shard(key).get(key)

    def get_many(self, keys) -> list:
        """Batch lookup: one lock acquisition per *touched shard*."""
        if self._n == 1:
            return self.shards[0].get_many(keys)
        by_shard: dict[int, tuple[list, list]] = {}
        sids = []
        for i, k in enumerate(keys):
            s = hash(k) % self._n
            sids.append(s)
            ii, kk = by_shard.setdefault(s, ([], []))
            ii.append(i)
            kk.append(k)
        out = [None] * len(keys)
        for s, (ii, kk) in by_shard.items():
            for i, v in zip(ii, self.shards[s].get_many(kk)):
                out[i] = v
        return out

    def put(self, key, val) -> None:
        self._shard(key).put(key, val)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def stats(self) -> dict:
        per = [s.stats() for s in self.shards]
        hits = sum(p["hits"] for p in per)
        misses = sum(p["misses"] for p in per)
        return {"size": sum(p["size"] for p in per),
                "capacity": self.capacity, "hits": hits, "misses": misses,
                "hit_rate": round(hits / max(1, hits + misses), 4),
                "shards": [{"size": p["size"], "hits": p["hits"],
                            "misses": p["misses"],
                            "hit_rate": p["hit_rate"]} for p in per]}


class _CacheEntry:
    """A cached ok-envelope plus its lazily-built binary response chunk:
    a warm binary bulk wave is served as a join of cached byte segments,
    no per-block re-encoding."""

    __slots__ = ("env", "seg")

    def __init__(self, env: dict):
        self.env = env
        self.seg: bytes | None = None


class EndpointStats:
    """Per-endpoint latency/error accounting, backed by the metrics layer.

    The reservoir is a :class:`repro_torch.obs.metrics.Histogram` (newest 4096
    observations, like the deque it replaced) plus an error
    :class:`~repro_torch.obs.metrics.Counter`; :meth:`summary` renders the
    legacy shape (``requests``/``errors``/``p50_us``/``p99_us`` — see
    ``repro_torch.obs.metrics.ENDPOINT_ALIASES``) from the instruments, so the
    histogram is the single source of truth."""

    def __init__(self, keep: int = 4096, name: str = "endpoint"):
        self.latency = obs_metrics.Histogram(f"{name}.latency_s", keep=keep)
        self._errors = obs_metrics.Counter(f"{name}.errors")

    @property
    def requests(self) -> int:
        return self.latency.count

    @property
    def errors(self) -> int:
        return self._errors.value

    def observe(self, seconds: float, *, error: bool = False) -> None:
        self.latency.observe(seconds)
        if error:
            self._errors.inc()

    def observe_many(self, seconds_each: float, n: int, errors: int) -> None:
        """n requests that shared one batched pass (single lock round-trip
        on the histogram — see :meth:`repro_torch.obs.metrics.Histogram.observe_many`)."""
        self.latency.observe_many(seconds_each, n)
        if errors:
            self._errors.inc(errors)

    def summary(self) -> dict:
        snap = self.latency.snapshot()
        out = {"requests": snap["count"], "errors": self._errors.value}
        if snap["count"]:
            out["p50_us"] = round(snap["p50"] * 1e6, 1)
            out["p99_us"] = round(snap["p99"] * 1e6, 1)
        return out


class _Coalescer:
    """Background worker turning single predicts into per-uarch batches.

    Batching is *natural*: the worker drains whatever is already queued and
    serves it as one batch — under load, batches form because serving takes
    time while new requests queue; an idle single request pays no artificial
    delay. ``window_s > 0`` additionally holds a lone request back up to
    that long hoping for company (higher latency, bigger batches)."""

    def __init__(self, service: "PredictionService", max_batch: int,
                 window_s: float):
        self.service = service
        self.max_batch = max_batch
        self.window_s = window_s
        self.queue: queue.Queue = queue.Queue()
        self.batch_sizes: deque = deque(maxlen=4096)
        self.batches = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.closed = False          # guarded by _submit_lock
        self._submit_lock = threading.Lock()

    @staticmethod
    def _closed_response() -> dict:
        return {"ok": False, "error": {"type": "ServiceClosed",
                                       "message": "service closed before "
                                       "the request was served"}}

    def start(self) -> None:
        if self._thread is None:
            with self._submit_lock:
                self.closed = False
            self._stop.clear()  # a stopped coalescer must be restartable
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="uops-coalescer")
            self._thread.start()

    def submit(self, item) -> None:
        """Enqueue under the close lock: a submit racing stop() either
        lands before the drain or is refused, never abandoned."""
        with self._submit_lock:
            if self.closed:
                item[2].set_result(self._closed_response())
            else:
                self.queue.put(item)

    def stop(self) -> None:
        self._stop.set()
        self.queue.put(None)  # wake the worker
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fail pending futures instead of abandoning their callers; the
        # lock closes the submit-after-drain window
        with self._submit_lock:
            self.closed = True
            while True:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item[2].done():
                    item[2].set_result(self._closed_response())

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                continue
            batch = [item]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                try:
                    nxt = self.queue.get_nowait()
                except queue.Empty:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        nxt = self.queue.get(timeout=left)
                    except queue.Empty:
                        break
                if nxt is None:
                    break
                batch.append(nxt)
            self.batches += 1
            self.batch_sizes.append(len(batch))
            groups: dict[str, list] = {}
            for uarch, code, fut, tid in batch:
                groups.setdefault(uarch, []).append((code, fut, tid))
            for uarch, entries in groups.items():
                codes = [c for c, _, _ in entries]
                tids = [t for _, _, t in entries]
                try:
                    results, hits = self.service._serve_group(
                        uarch, codes, trace_ids=tids)
                except Exception as e:  # noqa: BLE001 - the worker thread
                    # must survive anything (a dead coalescer hangs every
                    # future client); unexpected errors become responses
                    err = {"ok": False, "error": protocol.error_to_dict(e)}
                    results, hits = [err] * len(entries), [False] * len(entries)
                for (_, fut, _), res, hit in zip(entries, results, hits):
                    # the cache-hit flag rides the future (the shared
                    # envelope must not be mutated per-request); predict()
                    # reads it for the access log
                    fut.cache_hit = hit
                    if not fut.done():
                        fut.set_result(res)

    def stats(self) -> dict:
        sizes = list(self.batch_sizes)
        out = {"batches": self.batches, "queued": self.queue.qsize()}
        if sizes:
            out["mean_batch"] = round(sum(sizes) / len(sizes), 2)
            out["max_batch"] = max(sizes)
        return out


class PredictionService:
    """In-process service: registry + per-uarch batch predictors + cache.

    ``predict_backend`` and ``predict_device`` are each predictor's
    ``backend`` and ``device`` (:class:`BatchPredictor`: by default the
    ``cuda`` kernel on ``cuda:0``)."""

    def __init__(self, registry: ModelRegistry, isa=None, *,
                 issue_width: int = 4, cache_size: int = 4096,
                 cache_shards: int = 8, wave_cache_size: int = 256,
                 max_batch: int = 64,
                 batch_window_s: float = 0.0, start: bool = True,
                 access_log=None, access_log_max_bytes: int | None = None,
                 slow_request_us: float | None = None,
                 predict_backend: str | None = None,
                 predict_device=None,
                 min_device_blocks: int | None = None):
        self.registry = registry
        self.isa = isa if isa is not None else TEST_ISA
        self.issue_width = issue_width
        self.cache = ShardedLRU(cache_size, shards=cache_shards)
        # exact-request cache for the binary wire: the binary encoding is
        # canonical (unlike JSON, where key order / whitespace vary), so
        # identical request payload bytes imply an identical response up
        # to the trace id. Entries are (uarch, model_version, n, tail) and
        # are revalidated against the registry version on every hit.
        self.wave_cache = LRUCache(wave_cache_size)
        self.dedup_hits = 0  # identical requests coalesced within one wave
        self.endpoints: dict[str, EndpointStats] = {}
        self._predictors: dict[str, tuple[int, BatchPredictor]] = {}
        self._plock = threading.Lock()
        self.predict_backend = predict_backend
        self.predict_device = predict_device
        self.min_device_blocks = min_device_blocks
        self.coalescer = _Coalescer(self, max_batch, batch_window_s)
        self.started = time.time()
        self._front_door = None  # set by PredictionServer (admission stats)
        self._draining = threading.Event()
        # access log (newline-JSON, one record per request) and the
        # slow-request WARNING budget; constructor args override the
        # REPRO_ACCESS_LOG / REPRO_SLOW_REQUEST_US env knobs
        if access_log is None:
            access_log = os.environ.get(ENV_ACCESS_LOG) or None
        if access_log_max_bytes is None:
            env = os.environ.get(ENV_ACCESS_LOG_MAX, "").strip()
            access_log_max_bytes = int(env) if env else None
        if slow_request_us is None:
            env = os.environ.get(ENV_SLOW_US, "").strip()
            slow_request_us = float(env) if env else None
        self.access_log_path = access_log
        self.access_log_max_bytes = access_log_max_bytes
        self.slow_request_us = slow_request_us
        self._access_fh = None
        self._access_lock = threading.Lock()
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.coalescer.start()

    def close(self) -> None:
        self.coalescer.stop()
        with self._access_lock:
            if self._access_fh is not None:
                self._access_fh.close()
                self._access_fh = None

    # -- access log / slow-request flagging --------------------------------
    def _access(self, endpoint: str, trace_id: str, batch: int,
                cache_hits: int, wall_s: float, ok: bool) -> None:
        """One access record per served request (or per explicit batch):
        appended as newline-JSON when ``REPRO_ACCESS_LOG`` is set, and
        escalated to a WARNING when the request exceeded the configured
        latency budget."""
        wall_us = round(wall_s * 1e6, 1)
        if self.access_log_path is not None:
            rec = {"ts": round(time.time(), 3), "trace_id": trace_id,
                   "endpoint": endpoint, "batch": batch,
                   "cache_hits": cache_hits, "wall_us": wall_us, "ok": ok}
            line = json.dumps(rec, sort_keys=True)
            with self._access_lock:
                if self._access_fh is None:
                    self._access_fh = open(self.access_log_path, "a",
                                           buffering=1)
                self._access_fh.write(line + "\n")
                # size-based keep-1 rollover: long-lived servers must not
                # grow the log unboundedly (REPRO_ACCESS_LOG_MAX_BYTES)
                if (self.access_log_max_bytes is not None
                        and self._access_fh.tell()
                        >= self.access_log_max_bytes):
                    self._access_fh.close()
                    self._access_fh = None
                    os.replace(self.access_log_path,
                               str(self.access_log_path) + ".1")
        if self.slow_request_us is not None and wall_us > self.slow_request_us:
            _LOG.warning("slow request trace_id=%s endpoint=%s batch=%d "
                         "wall_us=%.1f (budget %.1f)", trace_id, endpoint,
                         batch, wall_us, self.slow_request_us)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- predictors / hot reload ------------------------------------------
    def _predictor(self, uarch: str) -> tuple[int, BatchPredictor]:
        handle = self.registry.get(uarch)  # stats + hot reload happen here
        with self._plock:
            cached = self._predictors.get(uarch)
            if cached is not None and cached[0] == handle.version:
                return cached
            bp = BatchPredictor(handle.model, self.isa, self.issue_width,
                                backend=self.predict_backend,
                                device=self.predict_device,
                                min_device_blocks=self.min_device_blocks)
            self._predictors[uarch] = (handle.version, bp)
            return self._predictors[uarch]

    # -- core serving ------------------------------------------------------
    def _serve_entries(self, uarch: str, packed, trace_ids=None):
        """Answer many *packed* blocks for one uarch: sharded cache
        lookups, one batched predictor pass over the misses, structured
        errors per block. Returns ``(entries, cache_hit_flags, bp)`` where
        each entry is a :class:`_CacheEntry` (ok) or an error-envelope
        dict, and ``bp`` is the predictor (None if the registry failed).
        Traced as a ``server.serve_group`` span carrying the request trace
        ids; the first id is set as ``trace_id`` so nested batch-predictor
        spans on this thread inherit it."""
        with obs.span("server.serve_group", uarch=uarch, batch=len(packed),
                      trace_id=(trace_ids[0] if trace_ids else None),
                      trace_ids=list(trace_ids or ())) as sp:
            try:
                version, bp = self._predictor(uarch)
            except Exception as e:  # noqa: BLE001 - registry/artifact
                # failures (missing model, stale fingerprint, XML
                # ParseError from a half-written artifact, races with file
                # deletion...) must come back as structured errors, never
                # escape into the worker
                err = {"ok": False, "error": protocol.error_to_dict(e)}
                return [err] * len(packed), [False] * len(packed), None
            keys = [(version, protocol.packed_key(uarch, pb))
                    for pb in packed]
            out: list = [None] * len(packed)
            unique: dict = {}   # key -> first index needing computation
            dups: dict = {}     # index -> representative index
            hits = self.cache.get_many(keys)
            for i, (k, hit) in enumerate(zip(keys, hits)):
                if hit is not None:
                    out[i] = hit
                elif k in unique:
                    dups[i] = unique[k]  # identical in-flight request:
                    # compute once
                else:
                    unique[k] = i
            if dups:
                with self._plock:
                    self.dedup_hits += len(dups)
            sp.set(cache_hits=len(packed) - len(unique) - len(dups),
                   misses=len(unique))
            if unique:
                miss_idx = list(unique.values())
                results = bp.predict_batch(
                    [protocol.packed_to_instrs(packed[i])
                     for i in miss_idx], on_error="return")
                for i, res in zip(miss_idx, results):
                    if isinstance(res, UnknownInstructionError):
                        out[i] = {"ok": False,
                                  "error": protocol.error_to_dict(res)}
                    else:
                        entry = _CacheEntry(
                            {"ok": True, "uarch": uarch,
                             "result": protocol.prediction_to_dict(res)})
                        out[i] = entry
                        self.cache.put(keys[i], entry)
            for i, rep in dups.items():
                out[i] = out[rep]
            return out, [h is not None for h in hits], bp

    def _serve_group(self, uarch: str, codes: list,
                     trace_ids=None) -> tuple[list, list]:
        """Instr-object serving path (coalescer / in-process callers):
        same core as :meth:`_serve_entries`, envelopes unwrapped."""
        packed = [protocol.instrs_to_packed(c) for c in codes]
        entries, hits, _bp = self._serve_entries(uarch, packed, trace_ids)
        return [e.env if isinstance(e, _CacheEntry) else e
                for e in entries], hits

    def serve_wave_cached(self, payload: bytes):
        """Exact-request fast path for the binary wire: if this very
        request payload was answered before (and the model version is
        unchanged), return the encoded response payload with a fresh
        trace id — no decode, no Instr objects, no worker-pool hop. The
        front door serves these inline on the event loop. Returns None
        on a miss (caller falls through to the full path)."""
        ent = self.wave_cache.get(payload)
        if ent is None:
            return None
        uarch, version, n, tail = ent
        t0 = time.perf_counter()
        try:
            if self._predictor(uarch)[0] != version:
                return None  # hot-reloaded model: recompute
        except Exception:  # noqa: BLE001 - registry trouble: full path
            return None
        tid = _new_trace_id()
        dt = time.perf_counter() - t0
        self._stats_for("predict_batch").observe_many(dt / max(1, n), n, 0)
        self._access("predict_batch", tid, n, n, dt, True)
        return b"\x10" + tid.encode() + tail

    def serve_wire_batch(self, uarch: str, packed, *, binary: bool = False,
                         wave_key: bytes | None = None):
        """The front door's bulk-wave fast path: packed blocks in,
        wire-ready payload out — no Instr objects, no envelope deep
        copies on warm hits.

        JSON mode returns ``(envelopes, trace_id)`` where each envelope is
        a shallow copy of the cached one plus the request ``trace_id``
        (the envelope is serialized immediately; nested dicts are shared
        with the cache and must not be mutated). Binary mode returns
        ``(response_payload_bytes, trace_id)`` — per-block byte segments
        are cached next to the envelope, so a warm wave is a bytes join."""
        t0 = time.perf_counter()
        tid = _new_trace_id()
        with obs.span("server.predict_batch", uarch=uarch,
                      batch=len(packed), trace_id=tid):
            entries, hits, bp = self._serve_entries(uarch, packed, [tid])
        errors = 0
        if binary:
            pidx = bp.port_index if bp is not None else {}
            chunks = []
            for e in entries:
                if isinstance(e, _CacheEntry):
                    seg = e.seg
                    if seg is None:
                        seg = protocol.encode_pred_chunk(e.env, pidx)
                        e.seg = seg
                    chunks.append(seg)
                else:
                    errors += 1
                    chunks.append(protocol.encode_error_chunk(e))
            out = protocol.encode_predict_batch_resp(
                tid, uarch, bp.port_names if bp is not None else [], chunks)
            if wave_key is not None and errors == 0 and bp is not None:
                try:
                    version = self.registry.get(uarch).version
                except Exception:  # noqa: BLE001 - raced a reload: skip
                    version = None
                if version is not None:
                    # everything after the trace-id field is id-independent
                    self.wave_cache.put(
                        wave_key,
                        (uarch, version, len(packed), out[1 + len(tid):]))
        else:
            envs = []
            for e in entries:
                if isinstance(e, _CacheEntry):
                    envs.append({**e.env, "trace_id": tid})
                else:
                    errors += 1
                    envs.append({**e, "trace_id": tid})
            out = envs
        dt = time.perf_counter() - t0
        self._stats_for("predict_batch").observe_many(
            dt / max(1, len(packed)), len(entries), errors)
        self._access("predict_batch", tid, len(packed), sum(hits), dt,
                     errors == 0)
        return out, tid

    def _stats_for(self, endpoint: str) -> EndpointStats:
        st = self.endpoints.get(endpoint)
        if st is None:
            st = self.endpoints.setdefault(
                endpoint, EndpointStats(name=f"server.endpoint.{endpoint}"))
        return st

    # -- public API --------------------------------------------------------
    @staticmethod
    def _copy_env(env: dict) -> dict:
        """Fresh response envelope: cached entries (and dedup aliases, for
        results and errors alike) are shared, so in-process callers get a
        copy they may mutate without poisoning the LRU cache."""
        out = dict(env)
        if "result" in out:
            res = dict(out["result"])
            if "port_pressure" in res:
                res["port_pressure"] = dict(res["port_pressure"])
            out["result"] = res
        if "error" in out:
            out["error"] = dict(out["error"])
        return out

    def submit(self, uarch: str, code) -> Future:
        """Enqueue one block for coalesced prediction. The future resolves
        once a worker is running (``start()``); on ``close()`` pending
        futures resolve to a structured ServiceClosed error.  Each submit
        gets a fresh trace id, carried on the returned future as
        ``fut.trace_id`` and into the serving spans."""
        fut: Future = Future()
        fut.trace_id = _new_trace_id()
        fut.cache_hit = False
        self.coalescer.submit((uarch, list(code), fut, fut.trace_id))
        return fut

    def predict(self, uarch: str, code) -> dict:
        t0 = time.perf_counter()
        fut = self.submit(uarch, code)
        with obs.span("server.predict", uarch=uarch,
                      trace_id=fut.trace_id):
            res = fut.result()
        dt = time.perf_counter() - t0
        self._stats_for("predict").observe(dt, error=not res.get("ok"))
        self._access("predict", fut.trace_id, 1, int(fut.cache_hit), dt,
                     bool(res.get("ok")))
        out = self._copy_env(res)
        out["trace_id"] = fut.trace_id
        return out

    def predict_batch(self, uarch: str, blocks) -> list[dict]:
        """Explicitly batched path (one request, many blocks): bypasses the
        coalescing queue but shares cache and predictors.  The whole batch
        shares one trace id (returned in every envelope) and one access
        record."""
        t0 = time.perf_counter()
        tid = _new_trace_id()
        blocks = [list(b) for b in blocks]
        with obs.span("server.predict_batch", uarch=uarch,
                      batch=len(blocks), trace_id=tid):
            out, hits = self._serve_group(uarch, blocks, trace_ids=[tid])
        dt = time.perf_counter() - t0
        per = dt / max(1, len(blocks))
        self._stats_for("predict_batch").observe_many(
            per, len(out), sum(1 for r in out if not r.get("ok")))
        self._access("predict_batch", tid, len(blocks), sum(hits), dt,
                     all(r.get("ok") for r in out) if out else True)
        copies = [self._copy_env(r) for r in out]
        for c in copies:
            c["trace_id"] = tid
        return copies

    def uarches(self) -> list[str]:
        return self.registry.uarches()

    # -- resilience: drain + health ----------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self) -> dict:
        """Graceful drain: stop accepting new work on both wires (work
        ops get a typed ``Draining`` envelope), finish everything already
        in flight, keep answering introspection (ping/stats/metrics/
        health) so orchestrators can watch the queue empty.  Idempotent;
        there is deliberately no un-drain — restart the replica."""
        already = self._draining.is_set()
        self._draining.set()
        fd = self._front_door
        return {"draining": True, "was_draining": already,
                "inflight": (fd.admission.stats()["inflight"]
                             if fd is not None else 0)}

    def health(self) -> dict:
        """Liveness/readiness snapshot: drain state, queue depth and
        worker liveness (when a front door is attached), and model
        registry status — cheap enough to answer inline on the event
        loop, so it stays responsive under saturation."""
        out = {"status": "draining" if self.draining else "ok",
               "draining": self.draining,
               "uptime_s": round(time.time() - self.started, 1),
               "registry": self.registry.stats()}
        fd = self._front_door
        if fd is not None:
            adm = fd.admission.stats()
            out["queue_depth"] = adm["queue_depth"]
            out["inflight"] = adm["inflight"]
            liveness = getattr(fd._pool, "liveness", None)
            if liveness is not None:
                out["workers"] = liveness()
        return out

    def reload(self, uarch: str | None = None) -> list[str]:
        return self.registry.reload(uarch)

    def validate_block(self, uarch: str, code) -> list[str]:
        """Missing variant names for a block, without predicting."""
        return missing_specs(self.registry.get(uarch).model, code)

    def stats(self) -> dict:
        """The legacy nested stats shape (kept verbatim — clients and
        benches pin it); every numeric field is also exposed canonically
        through :meth:`metrics`. With a front door attached, admission
        control, wire-negotiation, and predictor-backend sections ride
        along (absent on a bare in-process service, whose shape is
        pinned)."""
        out = {
            "uptime_s": round(time.time() - self.started, 1),
            "endpoints": {k: v.summary()
                          for k, v in list(self.endpoints.items())},
            "cache": {**self.cache.stats(), "dedup_hits": self.dedup_hits},
            "coalescer": self.coalescer.stats(),
            "registry": self.registry.stats(),
        }
        fd = self._front_door
        if fd is not None:
            out["admission"] = fd.admission.stats()
            out["wire"] = dict(fd.wire_counts)
            out["wave_cache"] = self.wave_cache.stats()
            with self._plock:
                bps = [bp for _, bp in self._predictors.values()]
            if bps:
                agg: dict = {"backend": bps[0].backend}
                for bp in bps:
                    for k, v in bp.backend_stats().items():
                        if isinstance(v, (int, float)) and not isinstance(
                                v, bool):
                            agg[k] = agg.get(k, 0) + v
                out["predictor"] = agg
        return out

    def metrics(self) -> dict:
        """Canonical :class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot
        of the service: the per-endpoint latency histograms (the live
        instruments behind :class:`EndpointStats`) plus every numeric
        field of :meth:`stats` as ``server.*`` gauges."""
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.absorb_server_stats(reg, self.stats())
        snap = reg.snapshot()
        for ep, st in list(self.endpoints.items()):
            snap[f"server.endpoint.{ep}.latency_s"] = st.latency.snapshot()
        return snap


# ---------------------------------------------------------------------------
# TCP front end
# ---------------------------------------------------------------------------


def _corpus_stream(service: "PredictionService", msg: dict):
    """Per-shard response dicts for a JSON ``predict_corpus`` request:
    one ``{"shard": i, ...}`` envelope per shard in request order, then a
    final ``{"done": true}`` summary. Shared by both JSON front ends (the
    asyncio door adds per-shard admission on top)."""
    uarch = msg["uarch"]
    shards = [tuple(protocol.wire_to_packed(b) for b in shard)
              for shard in msg["shards"]]
    blocks = errors = 0
    with obs.span("server.predict_corpus", uarch=uarch, shards=len(shards)):
        for idx, shard in enumerate(shards):
            try:
                envs, _tid = service.serve_wire_batch(uarch, shard)
                blocks += len(shard)
                errors += sum(1 for e in envs if not e.get("ok", True))
                yield {"ok": True, "shard": idx, "result": envs}
            except Exception as e:  # noqa: BLE001 - structured per shard
                errors += 1
                yield {"ok": False, "shard": idx,
                       "error": protocol.error_to_dict(e)}
    yield {"ok": True, "done": True,
           "result": {"shards": len(shards), "blocks": blocks,
                      "errors": errors, "shed": 0}}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        service: PredictionService = self.server.service  # type: ignore
        while True:
            try:
                msg = protocol.recv_msg(self.rfile)
            except (ValueError, OSError):
                break
            if msg is None:
                break
            if isinstance(msg, dict) and msg.get("op") == "predict_corpus":
                if service.draining:
                    try:
                        protocol.send_msg(self.wfile,
                                          _draining_env(service))
                    except OSError:
                        break
                    continue
                # streaming op: one response line per shard + summary
                try:
                    for resp in _corpus_stream(service, msg):
                        protocol.send_msg(self.wfile, resp)
                except OSError:
                    break
                except Exception as e:  # noqa: BLE001 - malformed request
                    try:
                        protocol.send_msg(self.wfile, {
                            "ok": False,
                            "error": protocol.error_to_dict(e)})
                    except OSError:
                        break
                continue
            try:
                resp = self._dispatch(service, msg)
            except Exception as e:  # never kill the connection on one op
                resp = {"ok": False, "error": protocol.error_to_dict(e)}
            try:
                protocol.send_msg(self.wfile, resp)
            except OSError:
                break

    @staticmethod
    def _dispatch(service: PredictionService, msg: dict) -> dict:
        op = msg.get("op")
        if op == "health":
            return {"ok": True, "result": service.health()}
        if op == "drain":
            return {"ok": True, "result": service.drain()}
        if service.draining and op not in _INTROSPECT_OPS:
            return _draining_env(service)
        if op == "ping":
            return {"ok": True, "result": "pong",
                    "version": protocol.PROTOCOL_VERSION}
        if op == "uarches":
            return {"ok": True, "result": service.uarches()}
        if op == "stats":
            return {"ok": True, "result": service.stats()}
        if op == "metrics":
            return {"ok": True, "result": service.metrics()}
        if op == "reload":
            return {"ok": True,
                    "result": service.reload(msg.get("uarch"))}
        if op == "validate":
            code = protocol.block_from_wire(msg["block"])
            return {"ok": True,
                    "result": service.validate_block(msg["uarch"], code)}
        if op == "predict":
            code = protocol.block_from_wire(msg["block"])
            return service.predict(msg["uarch"], code)
        if op == "predict_batch":
            blocks = [protocol.block_from_wire(b) for b in msg["blocks"]]
            return {"ok": True,
                    "result": service.predict_batch(msg["uarch"], blocks)}
        return {"ok": False, "error": {"type": "BadRequest",
                                       "message": f"unknown op {op!r}"}}


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ThreadedPredictionServer:
    """The PR-7 one-thread-per-connection TCP server (JSON wire only).

    Kept as the saturation benchmark's baseline and as a minimal
    dependency-free fallback; the default front door is the asyncio
    :class:`PredictionServer` below."""

    def __init__(self, service: PredictionService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.service = service  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="uops-server")
        self._thread.start()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        self.service.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# admission control + asyncio front door
# ---------------------------------------------------------------------------


class WorkerCrashed(RuntimeError):
    """A worker thread died (a ``BaseException`` escaped the job) while
    running this request; the pool respawned a replacement thread and the
    request's future resolves to this typed error instead of hanging."""


class ResilientPool(Executor):
    """Bounded thread pool with worker-crash recovery.

    The stock ``ThreadPoolExecutor`` work item swallows ``BaseException``
    into the future and keeps the (possibly wounded) thread; and a thread
    killed hard enough to die between jobs silently shrinks the pool.
    This executor makes the failure mode explicit: a job that raises an
    ``Exception`` resolves its future with that exception as usual, but a
    ``BaseException`` escaping a job (a) resolves the future with a typed
    :class:`WorkerCrashed` so no caller blocks forever, (b) replenishes
    the pool with a fresh thread, and (c) lets the dying thread die.
    ``liveness()`` feeds the ``health`` op's worker section."""

    def __init__(self, max_workers: int,
                 thread_name_prefix: str = "worker"):
        self._max_workers = max(1, int(max_workers))
        self._prefix = thread_name_prefix
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: list = []
        self._crashes = 0
        self._seq = 0
        self._down = False
        for _ in range(self._max_workers):
            self._spawn()

    def _spawn(self) -> None:
        with self._lock:
            if self._down:
                return
            self._seq += 1
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self._prefix}-{self._seq}")
            self._threads.append(t)
        t.start()

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            fut, fn, args, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except Exception as e:  # normal job failure: thread survives
                fut.set_exception(e)
            except BaseException as e:
                # the thread is dying: resolve the future with a typed
                # error, replace the thread, then let this one unwind
                fut.set_exception(WorkerCrashed(
                    f"worker thread crashed mid-request: "
                    f"{type(e).__name__}: {e}"))
                me = threading.current_thread()
                with self._lock:
                    self._crashes += 1
                    self._threads = [t for t in self._threads if t is not me]
                    down = self._down
                if not down:
                    self._spawn()
                return

    def submit(self, fn, /, *args, **kwargs) -> Future:
        if self._down:
            raise RuntimeError("cannot schedule new futures after shutdown")
        fut: Future = Future()
        self._work.put((fut, fn, args, kwargs))
        return fut

    def liveness(self) -> dict:
        with self._lock:
            return {"configured": self._max_workers,
                    "alive": sum(1 for t in self._threads if t.is_alive()),
                    "crashed": self._crashes}

    def shutdown(self, wait: bool = True, *,
                 cancel_futures: bool = False) -> None:
        with self._lock:
            self._down = True
            threads = list(self._threads)
        for _ in range(len(threads) + self._max_workers):
            self._work.put(None)
        if wait:
            for t in threads:
                t.join(timeout=5)


#: ops still answered while draining (introspection + drain itself)
_INTROSPECT_OPS = frozenset(("ping", "uarches", "stats", "metrics",
                             "health", "drain"))


def _draining_env(service: "PredictionService") -> dict:
    """Typed envelope for work refused during graceful drain.  Carries
    the same ``retry_after_ms`` hint as the ``Overloaded`` envelope so
    clients back off — or fail over — instead of hammering a replica on
    its way out."""
    fd = getattr(service, "_front_door", None)
    retry_ms = (fd.admission.retry_hint_ms() if fd is not None
                else 1000.0)
    return {"ok": False,
            "error": {"type": "Draining",
                      "message": "server is draining: finishing in-flight "
                                 "work, not accepting new requests",
                      "retry_after_ms": retry_ms}}


class AdmissionController:
    """Bounded-queue admission with an EWMA-estimated latency budget.

    ``try_admit`` refuses (returns a shed reason) when the queue behind
    the worker pool is full, or when the estimated sojourn time
    ``(queued + 1) × ewma_service_time`` exceeds the request's latency
    budget — the request would blow its deadline anyway, so shedding it
    *now* keeps the queue from growing unboundedly and keeps p99 stable.
    Shed requests get a typed ``Overloaded`` error, never an unbounded
    queue slot."""

    def __init__(self, workers: int, max_queue: int = 256,
                 budget_us: float | None = None):
        self.workers = workers
        self.max_queue = max_queue
        self.default_budget_us = budget_us
        self._lock = threading.Lock()
        self._inflight = 0
        self._peak = 0
        self._admitted = 0
        self._shed_queue = 0
        self._shed_budget = 0
        self._ewma_s = 1e-3  # sojourn-time estimate, seeded at 1 ms

    def try_admit(self, budget_us=None) -> str | None:
        """None when admitted (caller must :meth:`release`), else the
        shed reason (``"queue_full"`` / ``"budget"``)."""
        with self._lock:
            queued = self._inflight - self.workers
            if queued >= self.max_queue:
                self._shed_queue += 1
                return "queue_full"
            b = self.default_budget_us
            if budget_us:
                b = budget_us
            if b and queued > 0 and (queued + 1) * self._ewma_s * 1e6 > b:
                self._shed_budget += 1
                return "budget"
            self._inflight += 1
            self._admitted += 1
            if self._inflight > self._peak:
                self._peak = self._inflight
            return None

    def release(self, elapsed_s: float) -> None:
        with self._lock:
            self._inflight -= 1
            self._ewma_s += 0.2 * (elapsed_s - self._ewma_s)

    def queue_depth(self) -> int:
        with self._lock:
            return max(0, self._inflight - self.workers)

    def retry_hint_ms(self) -> float:
        """The ``retry_after_ms`` hint: estimated time for the current
        queue to clear (shared by Overloaded and Draining envelopes)."""
        with self._lock:
            depth = max(0, self._inflight - self.workers)
            return round(max(1, depth) * self._ewma_s * 1e3, 1)

    @property
    def shed(self) -> int:
        return self._shed_queue + self._shed_budget

    def overloaded_env(self, reason: str) -> dict:
        """The typed load-shed response envelope."""
        with self._lock:
            depth = max(0, self._inflight - self.workers)
            retry_ms = round(max(1, depth) * self._ewma_s * 1e3, 1)
        return {"ok": False,
                "error": {"type": "Overloaded",
                          "message": f"server overloaded ({reason}): "
                                     f"retry after ~{retry_ms}ms",
                          "reason": reason, "queue_depth": depth,
                          "retry_after_ms": retry_ms}}

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers, "max_queue": self.max_queue,
                    "inflight": self._inflight,
                    "queue_depth": max(0, self._inflight - self.workers),
                    "peak_inflight": self._peak,
                    "admitted": self._admitted,
                    "shed": self._shed_queue + self._shed_budget,
                    "shed_queue_full": self._shed_queue,
                    "shed_budget": self._shed_budget,
                    "ewma_service_us": round(self._ewma_s * 1e6, 1),
                    "budget_us": self.default_budget_us or 0}


def _jline(env: dict) -> bytes:
    return json.dumps(env, separators=(",", ":")).encode() + b"\n"


def _bframe(env: dict) -> bytes:
    return protocol.frame(protocol.K_RESP, protocol.pack_value(env))


class PredictionServer:
    """Asyncio multi-worker front door around a :class:`PredictionService`.

    One event loop owns every connection; CPU-bound prediction work runs
    on a bounded worker pool behind the :class:`AdmissionController`
    (cheap introspection ops — ping/stats/metrics/uarches — answer inline
    so the server stays observable under saturation). The wire is
    negotiated per connection by sniffing the first byte: ``0xB5`` opens
    the length-prefixed binary protocol, anything else is the legacy
    newline-JSON (see ``protocol.py``), so old clients keep working
    unchanged. Bulk ``predict_batch`` requests take a zero-copy fast path
    (``PredictionService.serve_wire_batch``): packed blocks straight from
    the decoder to the sharded cache, responses joined from cached byte
    segments on the binary wire."""

    def __init__(self, service: PredictionService, host: str = "127.0.0.1",
                 port: int = 0, *, workers: int | None = None,
                 max_queue: int = 256,
                 latency_budget_us: float | None = None):
        self.service = service
        if workers is None:
            env = os.environ.get(ENV_WORKERS, "").strip()
            workers = int(env) if env else min(8, (os.cpu_count() or 1) * 4)
        if latency_budget_us is None:
            env = os.environ.get(ENV_BUDGET_US, "").strip()
            latency_budget_us = float(env) if env else None
        self.admission = AdmissionController(workers, max_queue,
                                             latency_budget_us)
        self.wire_counts = {"json_conns": 0, "binary_conns": 0,
                            "bad_frames": 0}
        service._front_door = self
        self._pool = ResilientPool(max_workers=workers,
                                   thread_name_prefix="uops-worker")
        self._host_arg, self._port_arg = host, port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._startup = threading.Event()
        self._startup_err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="uops-frontdoor")
        self._thread.start()
        self._startup.wait(timeout=10)
        if self._startup_err is not None:
            raise self._startup_err

    # -- lifecycle ---------------------------------------------------------
    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            srv = loop.run_until_complete(asyncio.start_server(
                self._handle_conn, self._host_arg, self._port_arg,
                limit=protocol.MAX_FRAME))
        except BaseException as e:  # noqa: BLE001 - surfaced to __init__
            self._startup_err = e
            self._startup.set()
            loop.close()
            return
        self._asrv = srv
        self.host, self.port = srv.sockets[0].getsockname()[:2]
        self._startup.set()
        try:
            loop.run_forever()
        finally:
            srv.close()
            loop.run_until_complete(srv.wait_closed())
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.close()

    def drain(self) -> dict:
        """Graceful drain of the attached service: new work is refused
        with a typed ``Draining`` envelope, in-flight work finishes."""
        return self.service.drain()

    def close(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)
        self.service.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        return {"admission": self.admission.stats(),
                "wire": dict(self.wire_counts)}

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader, writer) -> None:
        try:
            first = await reader.read(1)
            if not first:
                return
            if first[0] == protocol.BINARY_MAGIC:
                self.wire_counts["binary_conns"] += 1
                await self._binary_conn(reader, writer)
            else:
                self.wire_counts["json_conns"] += 1
                await self._json_conn(first, reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _json_conn(self, first: bytes, reader, writer) -> None:
        carry = first
        while True:
            line = await reader.readline()
            if carry:
                line, carry = carry + line, b""
            if not line:
                return
            if not line.strip():
                return  # legacy recv_msg treated a blank line as EOF
            try:
                msg = json.loads(line)
                if not isinstance(msg, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                writer.write(_jline({"ok": False,
                                     "error": protocol.error_to_dict(e)}))
                await writer.drain()
                continue  # line framing keeps the stream in sync
            if msg.get("op") == "predict_corpus":
                await self._corpus_json(msg, writer)
                continue
            writer.write(await self._route(msg, _jline))
            await writer.drain()

    async def _binary_conn(self, reader, writer) -> None:
        # the sniffer consumed the magic byte of the HELLO frame
        hdr = await reader.readexactly(5)
        kind, length = hdr[0], int.from_bytes(hdr[1:], "big")
        if kind != protocol.K_HELLO or length > 64:
            self.wire_counts["bad_frames"] += 1
            return
        payload = await reader.readexactly(length)
        version = payload[0] if payload else 0
        if version != protocol.BINARY_VERSION:
            writer.write(_bframe({"ok": False, "error": {
                "type": "BinaryProtocolError",
                "message": f"unsupported binary version {version}"}}))
            await writer.drain()
            return
        writer.write(protocol.frame(protocol.K_HELLO_ACK,
                                    bytes([protocol.BINARY_VERSION])))
        await writer.drain()
        while True:
            try:
                hdr = await reader.readexactly(6)
            except asyncio.IncompleteReadError:
                return  # clean EOF at a frame boundary
            magic, kind = hdr[0], hdr[1]
            length = int.from_bytes(hdr[2:], "big")
            if magic != protocol.BINARY_MAGIC or length > protocol.MAX_FRAME:
                # stream desync: report and close (cannot resynchronize)
                self.wire_counts["bad_frames"] += 1
                writer.write(_bframe({"ok": False, "error": {
                    "type": "BinaryProtocolError",
                    "message": "frame desync (bad magic or oversized "
                               "frame); closing connection"}}))
                await writer.drain()
                return
            payload = await reader.readexactly(length)
            if kind == protocol.K_PREDICT_CORPUS:
                await self._corpus_binary(payload, writer)
                continue
            writer.write(await self._dispatch_binary(kind, payload))
            await writer.drain()

    async def _dispatch_binary(self, kind: int, payload: bytes) -> bytes:
        if kind == protocol.K_PREDICT_BATCH:
            if self.service.draining:
                return _bframe(_draining_env(self.service))
            fast = self.service.serve_wave_cached(payload)
            if fast is not None:  # exact-request hit: answer on the loop
                return protocol.frame(protocol.K_PREDICT_BATCH_RESP, fast)
            try:
                uarch, budget_us, blocks = protocol.decode_predict_batch(
                    payload)
            except protocol.BinaryProtocolError as e:
                self.wire_counts["bad_frames"] += 1
                return _bframe({"ok": False,
                                "error": protocol.error_to_dict(e)})
            service = self.service

            def work() -> bytes:
                try:
                    resp, _tid = service.serve_wire_batch(
                        uarch, blocks, binary=True, wave_key=payload)
                except Exception as e:  # noqa: BLE001 - structured error
                    return _bframe({"ok": False,
                                    "error": protocol.error_to_dict(e)})
                return protocol.frame(protocol.K_PREDICT_BATCH_RESP, resp)

            return await self._admitted(work, budget_us, _bframe)
        if kind == protocol.K_MSG:
            try:
                msg = protocol.unpack_value(payload)
                if not isinstance(msg, dict):
                    raise protocol.BinaryProtocolError(
                        "request must be a dict")
            except protocol.BinaryProtocolError as e:
                self.wire_counts["bad_frames"] += 1
                return _bframe({"ok": False,
                                "error": protocol.error_to_dict(e)})
            return await self._route(msg, _bframe)
        if kind == protocol.K_HELLO:  # redundant HELLO: re-ack
            return protocol.frame(protocol.K_HELLO_ACK,
                                  bytes([protocol.BINARY_VERSION]))
        self.wire_counts["bad_frames"] += 1
        return _bframe({"ok": False, "error": {
            "type": "BinaryProtocolError",
            "message": f"unknown frame kind {kind}"}})

    # -- bulk corpus streaming ---------------------------------------------
    async def _corpus_json(self, msg: dict, writer) -> None:
        """Stream a JSON ``predict_corpus``: one response line per shard
        (each shard individually admission-controlled — a shed shard
        arrives as an ``Overloaded`` envelope tagged with its index, the
        stream carries on) and a final ``done`` summary line."""
        service = self.service
        if service.draining:
            writer.write(_jline(_draining_env(service)))
            await writer.drain()
            return
        try:
            uarch = msg["uarch"]
            shards = [tuple(protocol.wire_to_packed(b) for b in shard)
                      for shard in msg["shards"]]
        except Exception as e:  # noqa: BLE001 - malformed request
            writer.write(_jline({"ok": False,
                                 "error": protocol.error_to_dict(e)}))
            await writer.drain()
            return
        budget_us = msg.get("budget_us")
        loop = asyncio.get_running_loop()
        blocks = errors = shed = 0
        with obs.span("server.predict_corpus", uarch=uarch,
                      shards=len(shards)):
            for idx, shard in enumerate(shards):
                reason = self.admission.try_admit(budget_us)
                if reason is not None:
                    shed += 1
                    env = self.admission.overloaded_env(reason)
                    env["shard"] = idx
                    writer.write(_jline(env))
                    await writer.drain()
                    continue

                def work(idx=idx, shard=shard):
                    try:
                        envs, _tid = service.serve_wire_batch(uarch, shard)
                    except Exception as e:  # noqa: BLE001 - structured
                        return 0, 1, _jline(
                            {"ok": False, "shard": idx,
                             "error": protocol.error_to_dict(e)})
                    bad = sum(1 for e in envs if not e.get("ok", True))
                    return len(shard), bad, _jline(
                        {"ok": True, "shard": idx, "result": envs})

                t0 = time.perf_counter()
                try:
                    n, bad, line = await loop.run_in_executor(
                        self._pool, work)
                finally:
                    self.admission.release(time.perf_counter() - t0)
                blocks += n
                errors += bad
                writer.write(line)
                await writer.drain()
        writer.write(_jline({"ok": True, "done": True,
                             "result": {"shards": len(shards),
                                        "blocks": blocks, "errors": errors,
                                        "shed": shed}}))
        await writer.drain()

    async def _corpus_binary(self, payload: bytes, writer) -> None:
        """Binary-wire twin of :meth:`_corpus_json`: K_PREDICT_CORPUS in,
        one K_PREDICT_CORPUS_SHARD frame per shard out (riding the
        predict_batch response codec), K_PREDICT_CORPUS_END summary
        last."""
        service = self.service
        if service.draining:
            # client treats a K_RESP error inside a corpus stream as a
            # request-level typed failure (raises, never hangs)
            writer.write(_bframe(_draining_env(service)))
            await writer.drain()
            return
        try:
            uarch, budget_us, shards = protocol.decode_predict_corpus(
                payload)
        except protocol.BinaryProtocolError as e:
            self.wire_counts["bad_frames"] += 1
            writer.write(_bframe({"ok": False,
                                  "error": protocol.error_to_dict(e)}))
            await writer.drain()
            return
        loop = asyncio.get_running_loop()
        blocks = errors = shed = 0
        with obs.span("server.predict_corpus", uarch=uarch,
                      shards=len(shards), wire="binary"):
            for idx, shard in enumerate(shards):
                reason = self.admission.try_admit(budget_us)
                if reason is not None:
                    shed += 1
                    env = self.admission.overloaded_env(reason)
                    writer.write(protocol.frame(
                        protocol.K_PREDICT_CORPUS_SHARD,
                        protocol.encode_corpus_shard_error(idx, env)))
                    await writer.drain()
                    continue

                def work(idx=idx, shard=shard):
                    try:
                        resp, _tid = service.serve_wire_batch(
                            uarch, shard, binary=True)
                    except Exception as e:  # noqa: BLE001 - structured
                        return 0, 1, protocol.frame(
                            protocol.K_PREDICT_CORPUS_SHARD,
                            protocol.encode_corpus_shard_error(
                                idx, {"ok": False,
                                      "error": protocol.error_to_dict(e)}))
                    return len(shard), 0, protocol.frame(
                        protocol.K_PREDICT_CORPUS_SHARD,
                        protocol.encode_corpus_shard(idx, resp))

                t0 = time.perf_counter()
                try:
                    n, bad, fr = await loop.run_in_executor(
                        self._pool, work)
                finally:
                    self.admission.release(time.perf_counter() - t0)
                blocks += n
                errors += bad
                writer.write(fr)
                await writer.drain()
        writer.write(protocol.frame(
            protocol.K_PREDICT_CORPUS_END,
            protocol.pack_value({"shards": len(shards), "blocks": blocks,
                                 "errors": errors, "shed": shed})))
        await writer.drain()

    # -- request routing ---------------------------------------------------
    async def _route(self, msg: dict, enc) -> bytes:
        """Dispatch one request dict, returning encoded response bytes.
        Heavy ops run on the worker pool behind admission control; cheap
        introspection answers inline on the event loop."""
        op = msg.get("op")
        service = self.service
        if service.draining and op not in _INTROSPECT_OPS:
            return enc(_draining_env(service))
        if op == "predict_batch":
            try:
                uarch = msg["uarch"]
                blocks = tuple(protocol.wire_to_packed(b)
                               for b in msg["blocks"])
            except Exception as e:  # noqa: BLE001 - malformed request
                return enc({"ok": False,
                            "error": protocol.error_to_dict(e)})

            def work() -> bytes:
                try:
                    envs, _tid = service.serve_wire_batch(uarch, blocks)
                except Exception as e:  # noqa: BLE001 - structured error
                    return enc({"ok": False,
                                "error": protocol.error_to_dict(e)})
                return enc({"ok": True, "result": envs})

            return await self._admitted(work, msg.get("budget_us"), enc)
        if op in _INTROSPECT_OPS:
            return enc(_Handler._dispatch(service, msg))

        def work() -> bytes:
            try:
                return enc(_Handler._dispatch(service, msg))
            except Exception as e:  # noqa: BLE001 - structured error
                return enc({"ok": False,
                            "error": protocol.error_to_dict(e)})

        if op == "predict":
            return await self._admitted(work, msg.get("budget_us"), enc)
        # reload / validate / unknown ops: pooled but never shed
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, work)

    async def _admitted(self, work, budget_us, enc) -> bytes:
        reason = self.admission.try_admit(budget_us)
        if reason is not None:
            return enc(self.admission.overloaded_env(reason))
        t0 = time.perf_counter()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                self._pool, work)
        finally:
            self.admission.release(time.perf_counter() - t0)


def start_server(models_dir, host: str = "127.0.0.1", port: int = 0,
                 workers: int | None = None, max_queue: int = 256,
                 latency_budget_us: float | None = None,
                 **service_kw) -> PredictionServer:
    """Registry → service → front door, in one call."""
    service = PredictionService(ModelRegistry(models_dir), **service_kw)
    return PredictionServer(service, host, port, workers=workers,
                            max_queue=max_queue,
                            latency_budget_us=latency_budget_us)
