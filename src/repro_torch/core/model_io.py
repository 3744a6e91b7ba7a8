"""Machine-readable output (§6.4): XML (uops.info-style) and JSON.

The XML schema mirrors uops.info's: one <instruction> element per variant
with <operand> children and per-architecture <architecture><measurement>
elements carrying ports=, uops=, plus <latency> edges per (src,dst) operand
pair. Round-trips losslessly through ``load_xml`` (used by the predictor and
by tests).

Also serializes the measurement engine's content-addressed result cache
(``save_measurement_cache`` / ``load_measurement_cache``), making
characterization campaigns incremental across processes.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from xml.dom import minidom

from repro_torch.core.characterize import InstrModel, PerfModel
from repro_torch.core.latency import LatencyEntry, LatencyResult
from repro_torch.core.port_usage import PortUsage
from repro_torch.core.simulator import Counters
from repro_torch.core.throughput import ThroughputResult


def _fmt(x) -> str:
    return f"{x:.6f}".rstrip("0").rstrip(".") if isinstance(x, float) else str(x)


def to_xml(model: PerfModel, isa=None) -> str:
    root = ET.Element("root")
    arch = ET.SubElement(root, "architecture", name=model.uarch)
    if model.fingerprint:
        arch.set("fingerprint", model.fingerprint)
    blk = ET.SubElement(arch, "blockingInstructions")
    for pc, nm in sorted(model.blocking.items()):
        ET.SubElement(blk, "blocking", ports=pc, instr=nm)
    for name, im in sorted(model.instructions.items()):
        el = ET.SubElement(root, "instruction", name=name)
        if isa is not None and name in isa:
            spec = isa[name]
            el.set("mnemonic", spec.mnemonic)
            el.set("extension", spec.extension)
            for o in spec.operands:
                ET.SubElement(el, "operand", name=o.name, type=o.otype,
                              r=str(int(o.read)), w=str(int(o.written)),
                              implicit=str(int(o.implicit)),
                              width=str(o.width))
        m = ET.SubElement(el, "measurement", arch=model.uarch,
                          uops=_fmt(im.uops))
        if im.port_usage is not None:
            m.set("ports", im.port_usage.notation())
        tp = im.throughput
        if tp is not None:
            m.set("tp_measured", _fmt(tp.measured))
            if tp.computed_from_ports is not None:
                m.set("tp_ports", _fmt(tp.computed_from_ports))
            if tp.high_value is not None:
                m.set("tp_high", _fmt(tp.high_value))
        if im.latency is not None:
            for (s, d), e in sorted(im.latency.entries.items()):
                le = ET.SubElement(m, "latency", src=s, dst=d,
                                   cycles=_fmt(e.value), kind=e.kind)
                if e.same_reg is not None:
                    le.set("same_reg", _fmt(e.same_reg))
                if e.high_value is not None:
                    le.set("high", _fmt(e.high_value))
    return minidom.parseString(ET.tostring(root)).toprettyxml(indent=" ")


def load_xml(text: str) -> PerfModel:
    root = ET.fromstring(text)
    arch = root.find("architecture")
    model = PerfModel(arch.get("name"))
    model.fingerprint = arch.get("fingerprint", "") or ""
    blk = arch.find("blockingInstructions")
    for b in (blk if blk is not None else []):
        model.blocking[b.get("ports")] = b.get("instr")
    for el in root.findall("instruction"):
        name = el.get("name")
        im = InstrModel(name)
        m = el.find("measurement")
        im.uops = float(m.get("uops"))
        pu = _parse_ports(m.get("ports"))
        pu.total_uops = im.uops
        im.port_usage = pu
        tp = ThroughputResult(name)
        tp.measured = float(m.get("tp_measured", 0))
        if m.get("tp_ports"):
            tp.computed_from_ports = float(m.get("tp_ports"))
        if m.get("tp_high"):
            tp.high_value = float(m.get("tp_high"))
        im.throughput = tp
        lat = LatencyResult(name)
        for le in m.findall("latency"):
            e = LatencyEntry(le.get("src"), le.get("dst"),
                             float(le.get("cycles")), le.get("kind"))
            if le.get("same_reg"):
                e.same_reg = float(le.get("same_reg"))
            if le.get("high"):
                e.high_value = float(le.get("high"))
            lat.entries[(e.src, e.dst)] = e
        im.latency = lat
        model.instructions[name] = im
    return model


def to_json(model: PerfModel) -> str:
    out = {"uarch": model.uarch, "blocking": model.blocking,
           "fingerprint": model.fingerprint,
           "run_seconds": model.run_seconds, "instructions": {}}
    for name, im in model.instructions.items():
        rec = {"uops": im.uops,
               "ports": im.port_usage.notation() if im.port_usage else None,
               "throughput": None, "latency": {}}
        if im.throughput:
            rec["throughput"] = {
                "measured": im.throughput.measured,
                "by_seq_len": im.throughput.by_seq_len,
                "with_breakers": im.throughput.with_breakers,
                "computed_from_ports": im.throughput.computed_from_ports,
                "high_value": im.throughput.high_value,
            }
        if im.latency:
            for (s, d), e in im.latency.entries.items():
                rec["latency"][f"{s}->{d}"] = {
                    "cycles": e.value, "kind": e.kind,
                    "same_reg": e.same_reg, "high": e.high_value,
                }
        out["instructions"][name] = rec
    return json.dumps(out, indent=1)


def _parse_ports(notation: str | None) -> PortUsage:
    pu = PortUsage()
    if notation and notation != "0":
        for part in notation.split("+"):
            n, pc = part.split("*p")
            pu.usage[frozenset(pc)] = int(n)
    return pu


def load_json(text: str) -> PerfModel:
    """Inverse of :func:`to_json` (JSON floats round-trip exactly, so a
    JSON-loaded model predicts identically to the in-memory one)."""
    data = json.loads(text)
    model = PerfModel(data["uarch"])
    model.blocking = dict(data.get("blocking") or {})
    model.fingerprint = data.get("fingerprint", "") or ""
    model.run_seconds = data.get("run_seconds", 0.0)
    for name, rec in data.get("instructions", {}).items():
        im = InstrModel(name)
        im.uops = float(rec["uops"])
        im.port_usage = _parse_ports(rec.get("ports"))
        im.port_usage.total_uops = im.uops
        tp = ThroughputResult(name)
        if rec.get("throughput"):
            t = rec["throughput"]
            tp.measured = t.get("measured", 0.0)
            tp.by_seq_len = {int(k): v
                             for k, v in (t.get("by_seq_len") or {}).items()}
            tp.with_breakers = t.get("with_breakers")
            tp.computed_from_ports = t.get("computed_from_ports")
            tp.high_value = t.get("high_value")
        im.throughput = tp
        lat = LatencyResult(name)
        for pair, e in (rec.get("latency") or {}).items():
            src, _, dst = pair.partition("->")
            entry = LatencyEntry(src, dst, e["cycles"],
                                 e.get("kind") or "exact")
            entry.same_reg = e.get("same_reg")
            entry.high_value = e.get("high")
            lat.entries[(src, dst)] = entry
        im.latency = lat
        model.instructions[name] = im
    return model


# ---------------------------------------------------------------------------
# persistent measurement cache (engine): key -> Counters
# ---------------------------------------------------------------------------


def save_measurement_cache(path, engine_or_cache, uarch: str | None = None
                           ) -> None:
    """Serialize an engine's content-addressed result cache to JSON.

    The machine's parameter fingerprint is stored alongside, so a cache can
    never be replayed against an edited uarch definition.  The write is
    atomic (tmp + ``os.replace``, the checkpoint/corpus convention): a
    crash — or an injected ``engine.cache_io`` torn write — leaves either
    the previous cache or the new one, never a truncated file."""
    from repro_torch.core.engine import machine_fingerprint  # noqa: PLC0415
    from repro_torch.faults import plan as faults  # noqa: PLC0415

    cache = getattr(engine_or_cache, "cache", engine_or_cache)
    machine = getattr(engine_or_cache, "machine", None)
    if uarch is None:
        uarch = machine.name if machine is not None else ""
    fp = machine_fingerprint(machine) if machine is not None else ""
    entries = {k: [c.cycles, c.port_uops] for k, c in cache.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = json.dumps({"uarch": uarch, "fingerprint": fp,
                       "entries": entries}).encode()
    if faults.active():
        faults.check("engine.cache_io", key=f"save:{path.name}")
        data = faults.filter_bytes("engine.cache_io", data,
                                   key=f"save:{path.name}")
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def load_measurement_cache(path, expect_fingerprint: str | None = None
                           ) -> dict:
    """Load a cache written by :func:`save_measurement_cache`.

    With ``expect_fingerprint`` set, a cache written for a machine with
    different hidden parameters raises ValueError (stale measurements must
    never be replayed as fresh ones)."""
    data = json.loads(Path(path).read_text())
    if (expect_fingerprint is not None
            and data.get("fingerprint") != expect_fingerprint):
        raise ValueError("machine fingerprint mismatch (uarch definition or "
                         "simulator changed since this cache was written)")
    return {k: Counters(cycles, dict(ports))
            for k, (cycles, ports) in data["entries"].items()}
