"""Export the full machine-readable instruction models (uops.info §6.4):
one Campaign characterizes every supported instruction variant on all
simulated microarchitectures concurrently and writes XML + JSON under
experiments/models/.

The campaign's measurement cache is persisted next to the models, so
re-running this script is incremental: a warm re-export replays every
microbenchmark from the content-addressed cache.

The PyTorch/CUDA port of examples/export_models.py: every measurement
wave runs through the CUDA wave-dispatch kernel on the card, and the
models and the measurement cache are the bytes the reference script
writes.  On a host without a card: REPRO_SIM_BACKEND=torch
REPRO_SIM_DEVICES=cpu.

Run: PYTHONPATH=src python examples/export_models_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import model_io
from repro_torch.core.engine import Campaign
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.simulator import SimMachine
from repro_torch.core.uarch import SIM_UARCHES

out = Path(__file__).resolve().parents[1] / "experiments" / "models"
out.mkdir(parents=True, exist_ok=True)
machines = [SimMachine(ua, TEST_ISA) for ua in SIM_UARCHES.values()]
campaign = Campaign(cache_dir=out / "cache")
result = campaign.run(machines, TEST_ISA)
for name, model in result.models.items():
    (out / f"{name}.xml").write_text(model_io.to_xml(model, TEST_ISA))
    (out / f"{name}.json").write_text(model_io.to_json(model))
    print(f"{name}: {len(model.instructions)} instruction variants -> "
          f"{out / name}.xml (+.json) in {result.uarch_seconds[name]:.1f}s "
          f"(cache hit rate {100 * result.stats[name]['hit_rate']:.1f}%)")
print(result.report())
