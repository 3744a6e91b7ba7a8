"""Wire protocol and textual block format for uops-as-a-service.

Dependency-free by design (stdlib json + sockets only): the service is the
thing other tools talk *to*, so it must not drag the measurement stack's
optional dependencies along.

Textual basic-block format (the CLI's input), one instruction per line::

    # comment
    IMUL_R64_R64 op1=R0 op2=R1
    DIV_R64 op1=R0 op2=R3 hi=R4 !high

``name=reg`` assigns an architectural register to an operand; ``!high``
selects the high divider operand class (§5.2.5 value hint).

Wire format: newline-delimited JSON messages over a TCP stream. Requests
are ``{"op": ..., ...}``; responses are ``{"ok": true, "result": ...}`` or
``{"ok": false, "error": {"type": ..., "message": ..., ...}}`` — the typed
:class:`~repro_torch.core.predictor.UnknownInstructionError` travels as a
structured error carrying the missing variant names.
"""
from __future__ import annotations

import json
import struct

from repro_torch.core.predictor import Prediction, UnknownInstructionError
from repro_torch.core.simulator import Instr
from repro_torch.faults import plan as _faults  # stdlib-only, keeps the wire dep-free

PROTOCOL_VERSION = 1


# ---------------------------------------------------------------------------
# textual block format
# ---------------------------------------------------------------------------


class BlockParseError(ValueError):
    pass


def parse_block(text: str, isa=None) -> list[Instr]:
    """Parse the textual block format into Instr instances. With ``isa``
    given, unknown variant names are rejected at parse time."""
    code: list[Instr] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        spec, args = parts[0], parts[1:]
        if isa is not None and spec not in isa:
            raise BlockParseError(f"line {lineno}: unknown instruction "
                                  f"variant {spec!r}")
        regs: dict[str, str] = {}
        value_hint = "low"
        for tok in args:
            if tok == "!high":
                value_hint = "high"
            elif tok == "!low":
                value_hint = "low"
            elif "=" in tok:
                k, _, v = tok.partition("=")
                regs[k] = v
            else:
                raise BlockParseError(f"line {lineno}: cannot parse operand "
                                      f"token {tok!r} (expected name=reg or "
                                      f"!high/!low)")
        code.append(Instr(spec, regs, value_hint))
    return code


def format_block(code) -> str:
    """Inverse of :func:`parse_block`."""
    lines = []
    for ins in code:
        toks = [ins.spec] + [f"{k}={v}" for k, v in ins.regs.items()]
        if ins.value_hint != "low":
            toks.append(f"!{ins.value_hint}")
        lines.append(" ".join(toks))
    return "\n".join(lines)


def block_key(uarch: str, code):
    """Hashable cache key: uarch + canonical (operand-order-free) block
    form. A nested tuple, not a string — building it is the hot path of a
    warm-cache hit, and tuple construction beats string formatting ~2x
    (``canonical_code`` stays the human-readable / persistent form)."""
    return (uarch, tuple((i.spec, tuple(sorted(i.regs.items())),
                          i.value_hint) for i in code))


# ---------------------------------------------------------------------------
# JSON encoding of Instr / Prediction / errors
# ---------------------------------------------------------------------------


def instr_to_wire(ins: Instr) -> dict:
    return {"spec": ins.spec, "regs": dict(ins.regs),
            "value_hint": ins.value_hint}


def instr_from_wire(d: dict) -> Instr:
    return Instr(d["spec"], dict(d.get("regs") or {}),
                 d.get("value_hint", "low"))


def block_to_wire(code) -> list:
    return [instr_to_wire(i) for i in code]


def block_from_wire(items) -> list:
    return [instr_from_wire(d) for d in items]


def prediction_to_dict(p: Prediction) -> dict:
    return {"cycles": p.cycles, "port_bound": p.port_bound,
            "latency_bound": p.latency_bound,
            "frontend_bound": p.frontend_bound,
            "port_pressure": dict(p.port_pressure),
            "bottleneck": p.bottleneck}


def error_to_dict(exc: BaseException) -> dict:
    out = {"type": type(exc).__name__, "message": str(exc)}
    if isinstance(exc, UnknownInstructionError):
        out["missing"] = list(exc.missing)
        out["uarch"] = exc.uarch
    for attr in ("available", "uarch"):
        if attr not in out and hasattr(exc, attr):
            out[attr] = getattr(exc, attr)
    return out


# ---------------------------------------------------------------------------
# framing: newline-delimited JSON over a socket file
# ---------------------------------------------------------------------------


def send_msg(wfile, obj) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode()
    if _faults.active():
        # corrupt the body *before* the newline delimiter: framing stays
        # intact, so the peer reads one garbled line and fails with a
        # typed decode error instead of desyncing or hanging
        body = _faults.filter_bytes("wire.frame", body).replace(b"\n", b" ")
        _faults.check("wire.frame")
    wfile.write(body + b"\n")
    wfile.flush()


def recv_msg(rfile):
    """Next message, or None on EOF."""
    line = rfile.readline()
    if not line:
        return None
    line = line.strip()
    if not line:
        return None
    return json.loads(line.decode() if isinstance(line, bytes) else line)


# ---------------------------------------------------------------------------
# binary wire format (negotiated per connection, JSON fallback)
# ---------------------------------------------------------------------------
#
# Frame layout (all multi-byte header fields big-endian)::
#
#     magic  u8   0xB5  (never a valid first byte of a JSON request: '{'
#                        is 0x7B — the server sniffs the first byte of a
#                        connection to pick the wire)
#     kind   u8   frame kind (K_* below)
#     length u32  payload length in bytes
#     payload     `length` bytes
#
# A connection opens with HELLO/HELLO_ACK carrying the binary protocol
# version. The HELLO payload deliberately ends with a newline so a legacy
# newline-JSON server reads one (unparseable) "line", fails, and closes —
# which the client detects and transparently falls back to JSON on a fresh
# connection. Generic requests/responses (K_MSG/K_RESP) carry the same
# dicts as the JSON wire in a compact tag encoding; the bulk-wave hot path
# (K_PREDICT_BATCH/K_PREDICT_BATCH_RESP) uses a specialized layout with
# per-message string tables and bulk struct packing so a wave of blocks is
# a handful of `struct` calls, not a per-field tree walk.

BINARY_MAGIC = 0xB5
BINARY_VERSION = 1
MAX_FRAME = 64 * 1024 * 1024  # hard cap on payload size (desync guard)

K_HELLO = 1
K_HELLO_ACK = 2
K_MSG = 3                 # generic request (tag-encoded dict)
K_RESP = 4                # generic response (tag-encoded dict)
K_PREDICT_BATCH = 5       # specialized bulk-wave request
K_PREDICT_BATCH_RESP = 6  # specialized bulk-wave response
K_PREDICT_CORPUS = 7        # bulk corpus request (many shards, one frame)
K_PREDICT_CORPUS_SHARD = 8  # streamed per-shard response
K_PREDICT_CORPUS_END = 9    # end-of-stream summary

_HDR = struct.Struct(">BBI")


class BinaryProtocolError(ValueError):
    """Malformed or out-of-spec binary frame."""


def hello_frame(version: int = BINARY_VERSION) -> bytes:
    # trailing \n makes legacy JSON servers fail fast (see module note)
    return frame(K_HELLO, bytes([version]) + b"\n")


def frame(kind: int, payload: bytes) -> bytes:
    if _faults.active():
        # corrupt the payload *before* the header is packed: the length
        # field stays consistent with what is sent, so the peer reads one
        # whole (garbled) frame and raises a typed decode error instead
        # of desyncing the stream or blocking on missing bytes
        payload = _faults.filter_bytes("wire.frame", payload)
        _faults.check("wire.frame")
    return _HDR.pack(BINARY_MAGIC, kind, len(payload)) + payload


def write_frame(wfile, kind: int, payload: bytes) -> None:
    wfile.write(frame(kind, payload))
    wfile.flush()


def read_frame(rfile):
    """Next ``(kind, payload)``, or None on clean EOF at a frame boundary.
    Raises :class:`BinaryProtocolError` on desync/oversized frames and
    ConnectionError on mid-frame EOF."""
    hdr = rfile.read(_HDR.size)
    if not hdr:
        return None
    while len(hdr) < _HDR.size:
        more = rfile.read(_HDR.size - len(hdr))
        if not more:
            raise ConnectionError("EOF inside binary frame header")
        hdr += more
    magic, kind, length = _HDR.unpack(hdr)
    if magic != BINARY_MAGIC:
        raise BinaryProtocolError(f"bad frame magic 0x{magic:02x}")
    if length > MAX_FRAME:
        raise BinaryProtocolError(f"frame too large ({length} bytes)")
    chunks = []
    got = 0
    while got < length:
        c = rfile.read(length - got)
        if not c:
            raise ConnectionError("EOF inside binary frame payload")
        chunks.append(c)
        got += len(c)
    return kind, b"".join(chunks)


# -- generic tag-encoded values (msgpack-style, stdlib only) ----------------

_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_STR, _T_BYTES, _T_LIST, _T_DICT = 5, 6, 7, 8

_F64 = struct.Struct("<d")


def _pack_varint(out: bytearray, n: int) -> None:
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _unpack_varint(buf, off: int):
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _pack_value(out: bytearray, v) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        _pack_varint(out, (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += _F64.pack(v)
    elif isinstance(v, str):
        b = v.encode()
        out.append(_T_STR)
        _pack_varint(out, len(b))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES)
        _pack_varint(out, len(v))
        out += v
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _pack_varint(out, len(v))
        for x in v:
            _pack_value(out, x)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _pack_varint(out, len(v))
        for k, x in v.items():
            _pack_value(out, k)
            _pack_value(out, x)
    else:
        raise TypeError(f"cannot encode {type(v).__name__} on the binary "
                        f"wire")


def _unpack_value(buf, off: int):
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_INT:
        z, off = _unpack_varint(buf, off)
        return (z >> 1) if not z & 1 else -((z + 1) >> 1), off
    if tag == _T_FLOAT:
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == _T_STR:
        n, off = _unpack_varint(buf, off)
        return bytes(buf[off:off + n]).decode(), off + n
    if tag == _T_BYTES:
        n, off = _unpack_varint(buf, off)
        return bytes(buf[off:off + n]), off + n
    if tag == _T_LIST:
        n, off = _unpack_varint(buf, off)
        out = []
        for _ in range(n):
            v, off = _unpack_value(buf, off)
            out.append(v)
        return out, off
    if tag == _T_DICT:
        n, off = _unpack_varint(buf, off)
        d = {}
        for _ in range(n):
            k, off = _unpack_value(buf, off)
            v, off = _unpack_value(buf, off)
            d[k] = v
        return d, off
    raise BinaryProtocolError(f"unknown value tag {tag}")


def pack_value(v) -> bytes:
    out = bytearray()
    _pack_value(out, v)
    return bytes(out)


def unpack_value(payload):
    try:
        v, off = _unpack_value(payload, 0)
    except (IndexError, struct.error) as exc:
        raise BinaryProtocolError(f"truncated payload: {exc}") from None
    except UnicodeDecodeError as exc:  # corrupted-in-flight string bytes
        raise BinaryProtocolError(f"malformed payload: {exc}") from None
    if off != len(payload):
        raise BinaryProtocolError(f"{len(payload) - off} trailing bytes "
                                  f"after value")
    return v


# -- packed block form (no Instr objects on the warm path) -------------------
#
# A packed block is a tuple of (spec, regs_items_tuple, value_hint). The
# server's warm path builds cache keys straight from this form; Instr
# objects are only materialized on cache misses.


def instrs_to_packed(code):
    return tuple((i.spec, tuple(i.regs.items()), i.value_hint)
                 for i in code)


def packed_to_instrs(pb):
    return [Instr(spec, dict(regs), hint) for spec, regs, hint in pb]


def packed_key(uarch: str, pb):
    """Same value as ``block_key(uarch, packed_to_instrs(pb))``."""
    return (uarch, tuple((spec, tuple(sorted(regs)), hint)
                         for spec, regs, hint in pb))


def packed_to_wire(pb) -> list:
    return [{"spec": spec, "regs": dict(regs), "value_hint": hint}
            for spec, regs, hint in pb]


def wire_to_packed(items):
    return tuple((d["spec"], tuple((d.get("regs") or {}).items()),
                  d.get("value_hint", "low")) for d in items)


# -- specialized bulk-wave request ------------------------------------------
#
# payload := varint budget_us
#            strtab: varint n, n × (varint len, utf8 bytes)
#            varint uarch_idx (into strtab)
#            varint n_blocks, per block varint n_instrs
#            varint n_ints, n_ints × u32 LE (one bulk struct call)
#
# Per instruction the int stream holds: spec_idx, hint_idx, n_regs, then
# n_regs × (name_idx, reg_idx). All strings are interned per message.


def encode_predict_batch(uarch: str, blocks, budget_us: int = 0) -> bytes:
    """``blocks``: iterable of packed blocks (see ``instrs_to_packed``)."""
    strtab: list[str] = []
    idx: dict[str, int] = {}

    def intern(s: str) -> int:
        i = idx.get(s)
        if i is None:
            i = idx[s] = len(strtab)
            strtab.append(s)
        return i

    uarch_idx = intern(uarch)
    ints: list[int] = []
    shape: list[int] = []
    for pb in blocks:
        shape.append(len(pb))
        for spec, regs, hint in pb:
            ints.append(intern(spec))
            ints.append(intern(hint))
            ints.append(len(regs))
            for k, v in regs:
                ints.append(intern(k))
                ints.append(intern(v))

    out = bytearray()
    _pack_varint(out, budget_us)
    _pack_varint(out, len(strtab))
    for s in strtab:
        b = s.encode()
        _pack_varint(out, len(b))
        out += b
    _pack_varint(out, uarch_idx)
    _pack_varint(out, len(shape))
    for n in shape:
        _pack_varint(out, n)
    _pack_varint(out, len(ints))
    out += struct.pack(f"<{len(ints)}I", *ints)
    return bytes(out)


def decode_predict_batch(payload):
    """-> (uarch, budget_us, tuple of packed blocks)."""
    try:
        off = 0
        budget_us, off = _unpack_varint(payload, off)
        n_str, off = _unpack_varint(payload, off)
        strtab = []
        for _ in range(n_str):
            n, off = _unpack_varint(payload, off)
            strtab.append(bytes(payload[off:off + n]).decode())
            off += n
        uarch_idx, off = _unpack_varint(payload, off)
        uarch = strtab[uarch_idx]
        n_blocks, off = _unpack_varint(payload, off)
        shape = []
        for _ in range(n_blocks):
            n, off = _unpack_varint(payload, off)
            shape.append(n)
        n_ints, off = _unpack_varint(payload, off)
        end = off + 4 * n_ints
        if end > len(payload):
            raise BinaryProtocolError("truncated int stream")
        ints = struct.unpack_from(f"<{n_ints}I", payload, off)
        off = end

        blocks = []
        p = 0
        for n_instr in shape:
            pb = []
            for _ in range(n_instr):
                spec = strtab[ints[p]]
                hint = strtab[ints[p + 1]]
                n_regs = ints[p + 2]
                p += 3
                regs = tuple((strtab[ints[p + 2 * j]],
                              strtab[ints[p + 2 * j + 1]])
                             for j in range(n_regs))
                p += 2 * n_regs
                pb.append((spec, regs, hint))
            blocks.append(tuple(pb))
        if p != n_ints:
            raise BinaryProtocolError("int stream length mismatch")
    except BinaryProtocolError:
        raise
    except (IndexError, struct.error, UnicodeDecodeError) as exc:
        raise BinaryProtocolError(f"malformed predict_batch request: "
                                  f"{exc}") from None
    return uarch, budget_us, tuple(blocks)


# -- specialized bulk-wave response -----------------------------------------
#
# payload := str trace_id | str uarch | port table (varint n, n × str)
#            varint n_blocks | n_blocks × chunk
# chunk   := 0x00 packed-prediction segment
#          | 0x01 tag-encoded envelope-remainder dict (errors / fallback)
#
# Packed segment: 4 × f64 LE (cycles, port_bound, latency_bound,
# frontend_bound), bottleneck idx u8, n_pressure u8, n × port idx u8,
# n × f64 LE. Per-block chunks are cached server-side next to the result
# envelope, so a warm bulk wave response is a header plus a bytes join.

BOTTLENECKS = ("ports", "latency", "frontend")
_SEG_HEAD = struct.Struct("<4dBB")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode()
    _pack_varint(out, len(b))
    out += b


def _unpack_str(buf, off: int):
    n, off = _unpack_varint(buf, off)
    return bytes(buf[off:off + n]).decode(), off + n


def encode_pred_chunk(env: dict, port_idx: dict) -> bytes:
    """One response chunk for an ok envelope. Falls back to the generic tag
    encoding when the prediction doesn't fit the packed layout (unknown
    port / >255 pressure entries)."""
    result = env["result"]
    pp = result["port_pressure"]
    try:
        bn = BOTTLENECKS.index(result["bottleneck"])
        if len(pp) > 255:
            raise ValueError
        ports = bytes(port_idx[p] for p in pp)
    except (ValueError, KeyError):
        return b"\x01" + pack_value(env)
    out = bytearray(b"\x00")
    out += _SEG_HEAD.pack(result["cycles"], result["port_bound"],
                          result["latency_bound"],
                          result["frontend_bound"], bn, len(pp))
    out += ports
    out += struct.pack(f"<{len(pp)}d", *pp.values())
    return bytes(out)


def encode_error_chunk(env: dict) -> bytes:
    """Chunk for a non-ok envelope (typed error travels generically)."""
    return b"\x01" + pack_value(env)


def encode_predict_batch_resp(trace_id: str, uarch: str, port_names,
                              chunks) -> bytes:
    out = bytearray()
    _pack_str(out, trace_id)
    _pack_str(out, uarch)
    _pack_varint(out, len(port_names))
    for p in port_names:
        _pack_str(out, p)
    _pack_varint(out, len(chunks))
    return bytes(out) + b"".join(chunks)


def decode_predict_batch_resp(payload):
    """-> list of response envelopes, exactly as the JSON wire shapes them
    (``{"ok": true, "uarch": ..., "result": ..., "trace_id": ...}``)."""
    try:
        off = 0
        trace_id, off = _unpack_str(payload, off)
        uarch, off = _unpack_str(payload, off)
        n_ports, off = _unpack_varint(payload, off)
        ports = []
        for _ in range(n_ports):
            p, off = _unpack_str(payload, off)
            ports.append(p)
        n_blocks, off = _unpack_varint(payload, off)
        envs = []
        for _ in range(n_blocks):
            kind = payload[off]
            off += 1
            if kind == 0:
                (cycles, port_bound, latency_bound, frontend_bound, bn,
                 n_pp) = _SEG_HEAD.unpack_from(payload, off)
                off += _SEG_HEAD.size
                pidx = payload[off:off + n_pp]
                off += n_pp
                vals = struct.unpack_from(f"<{n_pp}d", payload, off)
                off += 8 * n_pp
                env = {"ok": True, "uarch": uarch,
                       "result": {"cycles": cycles, "port_bound": port_bound,
                                  "latency_bound": latency_bound,
                                  "frontend_bound": frontend_bound,
                                  "port_pressure": {ports[i]: v for i, v
                                                    in zip(pidx, vals)},
                                  "bottleneck": BOTTLENECKS[bn]},
                       "trace_id": trace_id}
            elif kind == 1:
                env, off = _unpack_value(payload, off)
                env["trace_id"] = trace_id
            else:
                raise BinaryProtocolError(f"unknown chunk kind {kind}")
            envs.append(env)
        if off != len(payload):
            raise BinaryProtocolError("trailing bytes after response")
    except BinaryProtocolError:
        raise
    except (IndexError, struct.error, UnicodeDecodeError) as exc:
        raise BinaryProtocolError(f"malformed predict_batch response: "
                                  f"{exc}") from None
    return envs


# -- bulk corpus op (streamed per-shard responses) ---------------------------
#
# One K_PREDICT_CORPUS request frame carries every shard; the server
# answers with one K_PREDICT_CORPUS_SHARD frame *per shard* (each shard
# individually admission-controlled — a shed shard arrives as an error
# envelope without aborting the stream) and closes the exchange with a
# K_PREDICT_CORPUS_END summary. The per-shard payload embeds the
# predict_batch codecs, so a corpus shard response is byte-for-byte the
# bulk-wave response plus a shard index.
#
# request payload := varint budget_us | varint n_shards
#                    | n_shards × (varint len, predict_batch payload)
# shard payload   := varint shard_idx | u8 kind
#                    kind 0: predict_batch_resp payload
#                    kind 1: tag-encoded error envelope (shed / failure)
# end payload     := tag-encoded summary dict


def encode_predict_corpus(uarch: str, shards, budget_us: int = 0) -> bytes:
    """``shards``: iterable of shard block lists (packed blocks each)."""
    out = bytearray()
    _pack_varint(out, budget_us)
    chunks = [encode_predict_batch(uarch, shard) for shard in shards]
    _pack_varint(out, len(chunks))
    for c in chunks:
        _pack_varint(out, len(c))
        out += c
    return bytes(out)


def decode_predict_corpus(payload):
    """-> (uarch, budget_us, list of per-shard packed-block tuples)."""
    try:
        off = 0
        budget_us, off = _unpack_varint(payload, off)
        n_shards, off = _unpack_varint(payload, off)
        uarch = None
        shards = []
        for _ in range(n_shards):
            n, off = _unpack_varint(payload, off)
            ua, _b, blocks = decode_predict_batch(payload[off:off + n])
            off += n
            if uarch is None:
                uarch = ua
            elif ua != uarch:
                raise BinaryProtocolError(
                    f"corpus shards mix uarches ({uarch!r} vs {ua!r})")
            shards.append(blocks)
        if uarch is None:
            raise BinaryProtocolError("empty corpus request")
        if off != len(payload):
            raise BinaryProtocolError("trailing bytes after corpus request")
    except BinaryProtocolError:
        raise
    except (IndexError, struct.error) as exc:
        raise BinaryProtocolError(f"malformed predict_corpus request: "
                                  f"{exc}") from None
    return uarch, budget_us, shards


def encode_corpus_shard(idx: int, resp_payload: bytes) -> bytes:
    """Shard response riding a predict_batch_resp payload."""
    out = bytearray()
    _pack_varint(out, idx)
    out.append(0)
    return bytes(out) + resp_payload


def encode_corpus_shard_error(idx: int, env: dict) -> bytes:
    out = bytearray()
    _pack_varint(out, idx)
    out.append(1)
    return bytes(out) + pack_value(env)


def decode_corpus_shard(payload):
    """-> (shard_idx, envelopes) — a shed/failed shard yields its single
    error envelope, a served shard the per-block envelopes."""
    try:
        idx, off = _unpack_varint(payload, 0)
        kind = payload[off]
        off += 1
        if kind == 0:
            return idx, decode_predict_batch_resp(payload[off:])
        if kind == 1:
            return idx, [unpack_value(payload[off:])]
        raise BinaryProtocolError(f"unknown corpus shard kind {kind}")
    except BinaryProtocolError:
        raise
    except (IndexError, struct.error) as exc:
        raise BinaryProtocolError(f"malformed corpus shard response: "
                                  f"{exc}") from None
