"""Quickstart: the uops.info pipeline end to end, in a minute.

1. Characterize a handful of instructions on the simulated Skylake-like core
   (blocking discovery → Algorithm-1 port usage → per-pair latency →
   measured + LP throughput).
2. Export the machine-readable XML (uops.info-style).
3. Predict a loop kernel with the IACA-analogue and check it against the
   machine.

The PyTorch/CUDA port of examples/quickstart.py: the machine's waves run
through the CUDA wave-dispatch kernel on the card.  On a host without one,
ask for the plain torch version on the CPU:
REPRO_SIM_BACKEND=torch REPRO_SIM_DEVICES=cpu (it prints the same lines as
the reference script).

Run: PYTHONPATH=src python examples/quickstart_torch.py
"""
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import model_io
from repro_torch.core.engine import Campaign
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.machine import measure
from repro_torch.core.predictor import LegacyAnalyzer, predict
from repro_torch.core.simulator import Instr, SimMachine
from repro_torch.core.uarch import SIM_SKL

machine = SimMachine(SIM_SKL, TEST_ISA)
names = ["ADD_R64_R64", "IMUL_R64_R64", "ADC_R64_R64", "MOVQ2DQ_X_X",
         "SHLD_R64_R64_I8", "CMC", "MOV_R64_M64", "PSHUFD_X_X"]
print(f"characterizing {len(names)} instruction variants on {machine.name}…")
campaign = Campaign(instr_names=names)
result = campaign.run([machine], TEST_ISA)
model = result.models[machine.name]
stats = result.stats[machine.name]
print(f"  {stats['executions']} unique experiments executed, "
      f"{100 * stats['hit_rate']:.0f}% of {stats['requests']} requests "
      f"served from cache/dedup")

for n in names:
    im = model[n]
    lats = {f"{s}->{d}": round(e.value, 2)
            for (s, d), e in im.latency.entries.items()}
    print(f"  {n:18s} ports={im.port_usage.notation():14s} "
          f"tp={im.throughput.measured:.2f} lat={lats}")

xml = model_io.to_xml(model, TEST_ISA)
out = Path(tempfile.gettempdir()) / "quickstart_model.xml"
out.write_text(xml)
print(f"\nmachine-readable model written to {out} ({len(xml)} bytes)")

# --- predict a loop kernel and validate against the machine ---------------
loop = [Instr("IMUL_R64_R64", {"op1": "R0", "op2": "R1"}),
        Instr("ADD_R64_R64", {"op1": "R1", "op2": "R2"}),
        Instr("ADC_R64_R64", {"op1": "R3", "op2": "R0"})]
pred = predict(model, TEST_ISA, loop)
meas = measure(machine, loop)
legacy = LegacyAnalyzer(model, TEST_ISA).predict(loop)
print("\nloop kernel: IMUL r0,r1; ADD r1,r2; ADC r3,r0")
print(f"  predictor: {pred.cycles:.2f} cyc/iter (bottleneck: {pred.bottleneck})")
print(f"  machine:   {meas.cycles:.2f} cyc/iter")
print(f"  legacy(IACA-like, ignores flag deps): {legacy.cycles:.2f} cyc/iter")
