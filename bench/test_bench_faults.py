"""A whole run on the CPU at small sizes (the look for a card skipped),
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, and true without one."""
import time

import pytest
import torch

from bench import smoke

smoke.program_path()

from bench import harness  # noqa: E402


def _run(workload):
    res, lines = harness.run(workload, 2**31 + 41, 0.3, False,
                             t_start=time.perf_counter(),
                             **smoke.kwargs(workload))
    return res


def _prefill_fault(monkeypatch, fault):
    from repro_torch.models.transformer import MambaLM
    real = MambaLM.prefill

    def broken(self, batch, pad_to=None):
        toks = batch["tokens"]
        if fault == "half_batch":       # the rest's answers copied in
            h = toks.shape[0] // 2
            logits, state = real(self, {"tokens": toks[:h]}, pad_to)
            return torch.cat([logits, logits]), {
                k: v if k == "pos" else torch.cat([v, v], dim=1)
                for k, v in state.items()}
        logits, state = real(self, batch, pad_to)
        if fault == "state_unchanged":  # the state a prefill starts from
            state = {k: v if k == "pos" else torch.zeros_like(v)
                     for k, v in state.items()}
        if fault == "token_altered":
            logits = logits.clone()
            logits[:, 7] = logits.max(dim=-1).values + 1
        return logits, state

    monkeypatch.setattr(MambaLM, "prefill", broken)


def _train_fault(monkeypatch, fault):
    """``late_*``: the fault only from the step after the check steps on,
    as a path that changes after warm-up would."""
    from repro_torch.models.transformer import MambaLM
    from repro_torch.optim import adamw
    tr = {**harness.load_json(smoke.ROOT / "bench/workloads/"
                              "mamba2-2.7b.train_4k.json")["traffic"],
          **smoke.TRAFFIC["train"]}
    after = tr["check_steps"] if fault.startswith("late_") else 0
    fault = fault.removeprefix("late_")
    if fault == "state_unchanged":
        real_update = adamw.apply_update

        def unchanged(params, grads, state, cfg):
            if int(state.step) < after:
                return real_update(params, grads, state, cfg)
            return params, adamw.AdamWState(state.step + 1, state.mu,
                                            state.nu), {
                "grad_norm": torch.zeros(()), "lr": torch.zeros(())}
        monkeypatch.setattr(adamw, "apply_update", unchanged)
        return
    real = MambaLM.loss
    calls = []

    def broken(self, batch):
        calls.append(1)
        if len(calls) <= after * tr["microbatches"]:
            return real(self, batch)
        if fault == "half_batch":
            h = batch["tokens"].shape[0] // 2
            return real(self, {k: v[:h] for k, v in batch.items()})
        loss, m = real(self, batch)       # the step's answer altered
        return loss * 1.01, m

    monkeypatch.setattr(MambaLM, "loss", broken)


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill_4k",
                                      "mamba2-2.7b.train_4k"])
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_prefill_fault_is_not_correct(monkeypatch, fault):
    _prefill_fault(monkeypatch, fault)
    res = _run("mamba2-2.7b.prefill_4k")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "late_state_unchanged",
                                   "late_half_batch", "late_answer_altered"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    res = _run("mamba2-2.7b.train_4k")
    assert res["correct"] is False, res["checks"]
