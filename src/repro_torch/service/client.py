"""Client for uops-as-a-service: a persistent socket speaking either the
length-prefixed binary wire or the legacy newline-JSON protocol, plus a
``local_service`` helper that spins up registry + service + server
in-process (ephemeral port) for CLIs, tests, and benchmarks.

Wire negotiation (``wire="auto"``, the default): the client opens with a
binary HELLO frame; a new server answers HELLO_ACK and the connection runs
binary, a legacy server fails to parse the frame and closes, upon which
the client transparently reconnects in JSON mode. ``wire="json"`` skips
the probe; ``wire="binary"`` makes a JSON-only server a hard
:class:`ServiceUnavailable` error.

Robustness: ``connect_timeout``/``timeout`` bound every socket operation,
and calls that hit a connection reset are retried on a fresh connection
with exponential backoff (``retries``/``backoff_s``); when the budget is
exhausted — or a read times out — the client raises the typed
:class:`ServiceUnavailable` instead of a raw socket error. A server-side
load shed surfaces as :class:`ServiceOverloaded` (carrying
``queue_depth``/``retry_after_ms`` from the admission controller).
"""
from __future__ import annotations

import contextlib
import json
import random
import socket
import time

from repro_torch.service import protocol


class ServiceError(RuntimeError):
    """Server answered with a structured error (``resp["error"]``)."""

    def __init__(self, error: dict):
        self.error = dict(error or {})
        super().__init__(self.error.get("message", str(self.error)))

    @property
    def type(self) -> str:
        return self.error.get("type", "")


class ServiceOverloaded(ServiceError):
    """The admission controller shed this request (typed ``Overloaded``
    error; ``error["retry_after_ms"]`` suggests a backoff)."""


class ServiceDraining(ServiceError):
    """The server is draining (typed ``Draining`` error): it is finishing
    in-flight work and refusing new requests.  ``error["retry_after_ms"]``
    hints how long until the queue empties — retry against another
    replica, or after the hint if this one will restart."""


class ServiceUnavailable(ConnectionError):
    """The server could not be reached (or kept resetting the connection)
    within the client's retry budget, or a read timed out."""


class ServiceClient:
    """One connection to a prediction server. Not thread-safe: use one
    client per thread (the server multiplexes many connections)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0, *,
                 connect_timeout: float | None = None, wire: str = "auto",
                 retries: int = 2, backoff_s: float = 0.05,
                 retry_overloaded: int = 0):
        if wire not in ("auto", "binary", "json"):
            raise ValueError(f"unknown wire {wire!r}")
        self.host, self.port = host, port
        self.timeout = timeout
        self.connect_timeout = (timeout if connect_timeout is None
                                else connect_timeout)
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        # opt-in retry budget for typed Overloaded/Draining responses on
        # the simple ops; the sleep honors the server's retry_after_ms
        self.retry_overloaded = max(0, int(retry_overloaded))
        self._rng = random.Random()
        self._wire_pref = wire
        self.wire: str | None = None  # negotiated: "binary" | "json"
        self._sock = None
        self._rfile = self._wfile = None
        self._connect_with_retry()

    def _backoff_delay(self, attempt: int,
                       retry_after_ms: float | None = None) -> float:
        """Full-jitter exponential backoff: delay ~ U[0, backoff_s·2^a],
        floored at a server-provided ``retry_after_ms`` hint.  The old
        deterministic ``backoff_s·2^attempt`` schedule made every client
        that failed together retry together — a synchronized retry storm
        against a recovering server; the jitter decorrelates them."""
        delay = self._rng.uniform(0.0, self.backoff_s * (2 ** attempt))
        if retry_after_ms:
            delay = max(delay, float(retry_after_ms) / 1e3)
        return delay

    # -- connection management ---------------------------------------------
    def _open_socket(self):
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.settimeout(self.timeout)
        return sock, sock.makefile("rb"), sock.makefile("wb")

    def _connect_once(self) -> None:
        sock, rfile, wfile = self._open_socket()
        wire = "json"
        if self._wire_pref in ("auto", "binary"):
            try:
                wfile.write(protocol.hello_frame())
                wfile.flush()
                resp = protocol.read_frame(rfile)
                if resp is None or resp[0] != protocol.K_HELLO_ACK:
                    raise ConnectionError("no binary HELLO_ACK")
                wire = "binary"
            except (ConnectionError, OSError,
                    protocol.BinaryProtocolError) as e:
                # legacy JSON server: it closes (or answers garbage) on the
                # HELLO frame — reconnect plain unless binary was required
                with contextlib.suppress(OSError):
                    sock.close()
                if self._wire_pref == "binary":
                    raise ServiceUnavailable(
                        f"server does not speak the binary wire: {e}"
                    ) from None
                sock, rfile, wfile = self._open_socket()
        self._sock, self._rfile, self._wfile = sock, rfile, wfile
        self.wire = wire

    def _connect_with_retry(self) -> None:
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                self._connect_once()
                return
            except ServiceUnavailable:
                raise
            except (ConnectionError, OSError) as e:
                last = e
                if attempt < self.retries:
                    time.sleep(self._backoff_delay(attempt))
        raise ServiceUnavailable(
            f"cannot connect to {self.host}:{self.port} after "
            f"{self.retries + 1} attempts: {last}") from last

    def _reconnect(self, mode: str) -> None:
        self.close()
        self._connect_with_retry()
        if self.wire != mode:
            raise ServiceUnavailable(
                f"reconnected on the {self.wire} wire but the in-flight "
                f"request was encoded for {mode}")

    # -- plumbing ----------------------------------------------------------
    def _exchange(self, raw: bytes, mode: str):
        """Write pre-encoded request bytes, read one response — a
        ``(kind, payload)`` frame in binary mode, a raw line in JSON mode —
        retrying on a fresh connection after resets."""
        attempt = 0
        while True:
            try:
                self._wfile.write(raw)
                self._wfile.flush()
                if mode == "binary":
                    resp = protocol.read_frame(self._rfile)
                else:
                    resp = self._rfile.readline() or None
                if resp is None:
                    raise ConnectionError("server closed the connection")
                return resp
            except TimeoutError as e:  # socket.timeout: no blind retry of
                # a request the server may still be chewing on
                self.close()
                raise ServiceUnavailable(
                    f"request timed out after {self.timeout}s") from e
            except (ConnectionError, OSError) as e:
                self.close()
                if attempt >= self.retries:
                    raise ServiceUnavailable(
                        f"connection to {self.host}:{self.port} kept "
                        f"resetting ({attempt + 1} attempts): {e}") from e
                time.sleep(self._backoff_delay(attempt))
                attempt += 1
                self._reconnect(mode)

    def _call(self, msg: dict) -> dict:
        if self.wire == "binary":
            kind, payload = self._exchange(
                protocol.frame(protocol.K_MSG, protocol.pack_value(msg)),
                "binary")
            if kind != protocol.K_RESP:
                raise protocol.BinaryProtocolError(
                    f"unexpected response frame kind {kind}")
            return protocol.unpack_value(payload)
        line = self._exchange(
            json.dumps(msg, separators=(",", ":")).encode() + b"\n", "json")
        return json.loads(line)

    @staticmethod
    def _unwrap(resp: dict):
        if not resp.get("ok"):
            err = resp.get("error") or {}
            if err.get("type") == "Overloaded":
                raise ServiceOverloaded(err)
            if err.get("type") == "Draining":
                raise ServiceDraining(err)
            raise ServiceError(err)
        return resp.get("result")

    def _call_retrying(self, msg: dict):
        """``_call`` + ``_unwrap`` with an opt-in retry budget for typed
        Overloaded/Draining responses (``retry_overloaded``), sleeping a
        full-jitter backoff floored at the server's ``retry_after_ms``
        hint between attempts."""
        attempt = 0
        while True:
            try:
                return self._unwrap(self._call(msg))
            except (ServiceOverloaded, ServiceDraining) as e:
                if attempt >= self.retry_overloaded:
                    raise
                time.sleep(self._backoff_delay(
                    attempt, e.error.get("retry_after_ms")))
                attempt += 1

    @staticmethod
    def _as_packed_block(block):
        if isinstance(block, str):
            block = protocol.parse_block(block)
        return protocol.instrs_to_packed(block)

    @staticmethod
    def _as_wire_block(block):
        if isinstance(block, str):
            block = protocol.parse_block(block)
        return protocol.block_to_wire(block)

    # -- endpoints ---------------------------------------------------------
    def ping(self) -> bool:
        return self._call_retrying({"op": "ping"}) == "pong"

    def uarches(self) -> list[str]:
        return self._call_retrying({"op": "uarches"})

    def stats(self) -> dict:
        return self._call_retrying({"op": "stats"})

    def metrics(self) -> dict:
        """Canonical metrics snapshot (``{name: {"type": ..., ...}}``, see
        :mod:`repro_torch.obs.metrics`); ``stats()`` keeps the legacy shape."""
        return self._call_retrying({"op": "metrics"})

    def health(self) -> dict:
        """Server liveness/readiness: drain state, queue depth, worker
        liveness, model registry status (answered even while draining)."""
        return self._call_retrying({"op": "health"})

    def drain(self) -> dict:
        """Ask the server to drain gracefully (finish in-flight work,
        refuse new work with typed ``Draining`` envelopes)."""
        return self._unwrap(self._call({"op": "drain"}))

    def reload(self, uarch: str | None = None) -> list[str]:
        msg = {"op": "reload"}
        if uarch is not None:
            msg["uarch"] = uarch
        return self._unwrap(self._call(msg))

    def validate(self, uarch: str, block) -> list[str]:
        """Variant names in ``block`` the uarch's model cannot predict."""
        return self._unwrap(self._call({"op": "validate", "uarch": uarch,
                                        "block": self._as_wire_block(block)}))

    def predict(self, uarch: str, block, *, raw: bool = False):
        """Predict one block (textual format or list of Instr). Returns the
        prediction dict; with ``raw=True`` returns the full response
        envelope instead of raising on structured errors."""
        msg = {"op": "predict", "uarch": uarch,
               "block": self._as_wire_block(block)}
        if raw:
            return self._call(msg)
        return self._call_retrying(msg)

    def predict_batch(self, uarch: str, blocks, *,
                      budget_us: float | None = None) -> list[dict]:
        """Predict many blocks in one request. Returns the per-block
        response envelopes (callers pick apart ok/error per block) —
        identical payloads on either wire. ``budget_us`` asks the server
        to shed the request instead of queueing it past that latency."""
        prepared = self.prepare_batch(uarch, blocks, budget_us=budget_us)
        ok, shed, envs = self.send_prepared(prepared, decode=True)
        if not ok:
            self._unwrap(envs[0] if envs else {"ok": False})
        return envs

    def _read_stream(self, mode: str):
        """Read one follow-up response of a streaming op. Unlike
        :meth:`_exchange` there is no retry: replaying mid-stream is not
        safe, so any transport trouble is a hard ServiceUnavailable."""
        try:
            if mode == "binary":
                resp = protocol.read_frame(self._rfile)
            else:
                resp = self._rfile.readline() or None
            if resp is None:
                raise ConnectionError("server closed mid-stream")
            return resp
        except TimeoutError as e:
            self.close()
            raise ServiceUnavailable(
                f"stream read timed out after {self.timeout}s") from e
        except (ConnectionError, OSError) as e:
            self.close()
            raise ServiceUnavailable(
                f"connection lost mid-stream: {e}") from e

    def predict_corpus(self, uarch: str, shards, *,
                       budget_us: float | None = None):
        """Bulk corpus prediction: every shard in one request, responses
        streamed back per shard. Returns ``(shard_envelopes, summary)``
        where ``shard_envelopes[i]`` holds shard *i*'s per-block response
        envelopes — or its single error envelope when that shard was shed
        (typed ``Overloaded``) or failed; the stream carries on either
        way. ``summary`` is the server's end-of-stream tally
        (shards/blocks/errors/shed). Identical envelope payloads on either
        wire."""
        packed = [[self._as_packed_block(b) for b in shard]
                  for shard in shards]
        results: list = [None] * len(packed)
        if self.wire == "binary":
            raw = protocol.frame(
                protocol.K_PREDICT_CORPUS,
                protocol.encode_predict_corpus(uarch, packed,
                                               int(budget_us or 0)))
            kind, payload = self._exchange(raw, "binary")
            while True:
                if kind == protocol.K_PREDICT_CORPUS_SHARD:
                    idx, envs = protocol.decode_corpus_shard(payload)
                    results[idx] = envs
                elif kind == protocol.K_PREDICT_CORPUS_END:
                    return results, protocol.unpack_value(payload)
                elif kind == protocol.K_RESP:
                    # request-level error before any shard was served
                    self._unwrap(protocol.unpack_value(payload))
                    raise protocol.BinaryProtocolError(
                        "non-error K_RESP inside a corpus stream")
                else:
                    raise protocol.BinaryProtocolError(
                        f"unexpected frame kind {kind} in corpus stream")
                kind, payload = self._read_stream("binary")
        msg = {"op": "predict_corpus", "uarch": uarch,
               "shards": [[protocol.packed_to_wire(pb) for pb in shard]
                          for shard in packed]}
        if budget_us:
            msg["budget_us"] = budget_us
        raw = json.dumps(msg, separators=(",", ":")).encode() + b"\n"
        line = self._exchange(raw, "json")
        while True:
            env = json.loads(line)
            if env.get("done"):
                return results, env.get("result")
            if "shard" not in env:
                self._unwrap(env)  # request-level error: raises
                raise ServiceError({"message": "malformed corpus stream "
                                               "response (no shard index)"})
            results[env["shard"]] = (env["result"] if env.get("ok")
                                     else [env])
            line = self._read_stream("json")

    def predict_all(self, block) -> dict:
        """The CLI's sweep: one prediction per served uarch."""
        return {ua: self.predict(ua, block, raw=True)
                for ua in self.uarches()}

    # -- replayable pre-encoded requests (load generation) -----------------
    def prepare_batch(self, uarch: str, blocks, *,
                      budget_us: float | None = None) -> tuple:
        """Pre-encode a ``predict_batch`` request for this connection's
        wire. The returned opaque tuple can be replayed many times with
        :meth:`send_prepared` — encoding cost is paid once, which is what
        an open-loop load generator needs."""
        packed = [self._as_packed_block(b) for b in blocks]
        if self.wire == "binary":
            raw = protocol.frame(
                protocol.K_PREDICT_BATCH,
                protocol.encode_predict_batch(uarch, packed,
                                              int(budget_us or 0)))
            return ("binary", raw, len(packed))
        msg = {"op": "predict_batch", "uarch": uarch,
               "blocks": [protocol.packed_to_wire(pb) for pb in packed]}
        if budget_us:
            msg["budget_us"] = budget_us
        raw = json.dumps(msg, separators=(",", ":")).encode() + b"\n"
        return ("json", raw, len(packed))

    def send_prepared(self, prepared: tuple, *, decode: bool = True):
        """Send a prepared request; returns ``(ok, shed, envelopes)``.
        With ``decode=False`` the response body is only sniffed for
        ok/shed (the load generator's cheap mode) and ``envelopes`` is
        None."""
        mode, raw, _n = prepared
        if mode != self.wire:
            raise ServiceUnavailable(
                f"request prepared for the {mode} wire but connection "
                f"negotiated {self.wire}")
        resp = self._exchange(raw, mode)
        if mode == "binary":
            kind, payload = resp
            if kind == protocol.K_PREDICT_BATCH_RESP:
                if not decode:
                    return True, False, None
                return True, False, protocol.decode_predict_batch_resp(
                    payload)
            env = protocol.unpack_value(payload)
            err = (env.get("error") or {}) if isinstance(env, dict) else {}
            return False, err.get("type") == "Overloaded", [env]
        if not decode:
            if resp.startswith(b'{"ok":true'):
                return True, False, None
            return False, b'"type":"Overloaded"' in resp[:160], None
        envd = json.loads(resp)
        if envd.get("ok"):
            return True, False, envd["result"]
        err = envd.get("error") or {}
        return False, err.get("type") == "Overloaded", [envd]

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for f in (self._rfile, self._wfile):
            if f is not None:
                with contextlib.suppress(OSError):
                    f.close()
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
        self._rfile = self._wfile = self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def local_service(models_dir, wire: str = "auto", **service_kw):
    """Start server + client against ``models_dir`` on an ephemeral local
    port; yields the connected client, tears everything down after."""
    from repro_torch.service.server import start_server  # noqa: PLC0415

    server = start_server(models_dir, **service_kw)
    client = ServiceClient(server.host, server.port, wire=wire)
    try:
        yield client
    finally:
        client.close()
        server.close()
