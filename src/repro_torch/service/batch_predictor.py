"""Vectorized batch prediction: many basic blocks, one array pass.

``core/predictor.py`` is the single-block *reference*; this module is the
throughput path behind the service. It packs every block's summed port-usage
row into one dense ``(blocks × combos)`` matrix and computes all port bounds
with a single matrix product against the model's precomputed min-cut
candidate sets (the closed form in ``core/lp.py``), instead of solving one
LP per block. Front-end bounds, per-port pressure, the latency bound, and
the bottleneck tie-break reuse the reference helpers, so the results are
bit-identical to calling :func:`repro_torch.core.predictor.predict` per block:

* port-usage μop counts are integers (PortUsage / the XML schema), so the
  matrix product's float64 sums are exact regardless of summation order;
* the min-cut maximum over the model-wide candidate closure equals the
  maximum over each block's own closure (shrinking a candidate to the union
  of the combinations it contains only increases its ratio);
* blocks with more distinct combinations than ``CUT_COMBO_CAP`` fall back
  to the same LP on the same insertion-ordered usage dict as the reference.

Three vectorized backends share the same integer cut matrices
(:func:`repro_torch.core.lp.cut_matrices`): ``numpy``, a host matmul;
``torch``, the wrapper of ``kernels/port_bound.py`` on any device (the
hand-written kernel on a card, its plain PyTorch version on the CPU);
and ``cuda``, the same wrapper, required to run on a card.  On the
two device backends usage rows ship to the device as one int32 tensor,
``demand = u @ mask`` runs in integers against the device-resident
candidate masks, and the winning candidate per block is selected with an
exact integer cross-multiplication; only the final ``demand/size`` division
happens in float64 on the host, so the device path is bit-identical to the
scalar reference (equal rational ratios round to the same double).  A wave
launches at exactly its row count.

The default backend is ``REPRO_PREDICT_BACKEND``, else ``cuda``, on
``device`` (default ``cuda:0``).  There is no fallback: ``cuda`` without a
card raises when the predictor is built, and a launch that fails raises
from :meth:`BatchPredictor.predict_batch`.  What routes a wave to numpy is
semantic, as in the reference: fewer than ``min_device_blocks`` closed-form
rows, a non-integer uop count, or a row total that could overflow the
int32 cross products (the last two count ``device_fallbacks``).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch.core.device_mesh import resolve_device
from repro_torch.kernels import port_bound
from repro_torch.obs import tracer as obs
from repro_torch.core.characterize import PerfModel
from repro_torch.core.isa import ISA
from repro_torch.core.lp import (CUT_COMBO_CAP, cut_matrices,
                                 port_bound_from_usage, union_closure)
from repro_torch.core.predictor import (Prediction, UnknownInstructionError,
                                        _latency_bound, check_block,
                                        classify_bottleneck, port_pressure,
                                        sum_usage)

# below this many closed-form rows a wave stays on the host: the
# reference's threshold, kept so that both route the same waves
MIN_DEVICE_BLOCKS = 32
BACKENDS = ("numpy", "torch", "cuda")
ENV_BACKEND = "REPRO_PREDICT_BACKEND"


class BatchPredictor:
    """Precompiled predictor for one :class:`PerfModel`.

    With a ``machine`` attached (a simulated core or its measurement
    engine), the predictor also offers a *simulate-backed* mode:
    :meth:`simulate_batch` measures whole block waves on the machine —
    batched through its ``run_batch`` backend — giving the ground truth
    the analytic bounds can be judged against at workload scale.

    ``backend`` is ``numpy``, ``torch`` or ``cuda`` (default:
    ``REPRO_PREDICT_BACKEND``, else ``cuda``) and ``device`` the device of
    the two device backends (default ``cuda:0``).  ``backend_stats()``
    counts ``numpy_waves``, ``device_waves``, ``device_blocks``,
    ``device_fallbacks`` and ``device_compiles``: the one-time upload of
    the candidate mask and sizes to the device (and, on a card, the
    loading of the kernel's library) in this predictor."""

    def __init__(self, model: PerfModel, isa: ISA, issue_width: int = 4,
                 machine=None, *, backend: str | None = None,
                 device=None, min_device_blocks: int | None = None):
        self.model = model
        self.isa = isa
        self.issue_width = issue_width
        self.machine = machine
        # distinct port combinations across the model, in a fixed order
        combos: list[frozenset] = []
        index: dict[frozenset, int] = {}
        for im in model.instructions.values():
            if im.port_usage:
                for pc in im.port_usage.usage:
                    if pc not in index:
                        index[pc] = len(combos)
                        combos.append(pc)
        self._combos = combos
        self._combo_idx = index
        # model-wide min-cut candidates: all unions of the model's combos.
        # None => too many to enumerate; per-block closed form / LP instead.
        cand = union_closure(combos) if combos else []
        if cand:
            mask_i, size_i = cut_matrices(combos, cand)
            self._mask_i = mask_i                       # C×S int32
            self._size_i = size_i                       # S   int32
            self._cut_mask = mask_i.astype(float)       # C×S
            self._cut_size = size_i.astype(float)
        else:
            self._mask_i = self._size_i = None
            self._cut_mask = None
            self._cut_size = None
        # canonical port table (binary wire + device kernels index into it)
        self.port_names = sorted({p for pc in combos for p in pc})
        self.port_index = {p: i for i, p in enumerate(self.port_names)}
        # vectorized closed-form backend: "numpy" | "torch" | "cuda"
        if backend is None:
            backend = os.environ.get(ENV_BACKEND, "").strip() or "cuda"
        if backend not in BACKENDS:
            raise ValueError(f"unknown predict backend {backend!r} "
                             f"(one of {', '.join(BACKENDS)})")
        self.backend = backend
        self.device = None
        if backend != "numpy":
            self.device = resolve_device(device)
            if backend == "cuda" and self.device.type != "cuda":
                raise ValueError(f"predict backend 'cuda' runs on a CUDA "
                                 f"device, not {self.device}")
        self.min_device_blocks = (MIN_DEVICE_BLOCKS if min_device_blocks
                                  is None else min_device_blocks)
        self._dev_lock = threading.Lock()
        self._dev_mask = None                       # device-resident C×S
        self._dev_size = None                       # device-resident S
        # a list that keeps every device wave's inputs (u, mask, size), or
        # None
        self.launched_args: list | None = None
        self._stats = {"numpy_waves": 0, "device_waves": 0,
                       "device_blocks": 0, "device_compiles": 0,
                       "device_fallbacks": 0}

    # ------------------------------------------------------------------
    def predict(self, code) -> Prediction:
        return self.predict_batch([code])[0]

    def simulate_batch(self, blocks, kernel_lock=None,
                       devices=None) -> list[float]:
        """Measured steady-state cycles per block iteration, for a whole
        wave of blocks at once (Algorithm-2 differencing on the attached
        machine; the engine dedups the wave and executes the miss-set
        through the machine's batched backend — device-resident when the
        machine's backend is ``cuda``/``torch``, with warm waves skipping
        lowering via the machine's lowering cache).  ``kernel_lock``
        serializes GIL-bound kernel execution against other engines
        sharing the lock; host lowering/packing stays concurrent.

        ``devices`` (an integer count, ``"all"``, device names or a
        sequence of torch devices) re-places the machine's wave execution
        before this wave through its ``set_devices`` (see
        :mod:`repro_torch.core.device_mesh`: several devices split each
        wide enough chunk into lane blocks); results are bit-identical on
        every placement.  ``None`` keeps the
        machine's current placement (the ``REPRO_SIM_DEVICES``
        default)."""
        if self.machine is None:
            raise ValueError("simulate-backed mode needs a machine "
                             "(BatchPredictor(..., machine=...))")
        from repro_torch.core.engine import (  # noqa: PLC0415
            Experiment, as_engine)

        blocks = list(blocks)
        # the span inherits the serving request's trace_id when called
        # from a traced server thread (see repro_torch.obs.tracer)
        with obs.span("predict.simulate", blocks=len(blocks)):
            if devices is not None:
                setter = getattr(self.machine, "set_devices", None)
                if setter is not None:
                    setter(devices)
            engine = as_engine(self.machine)
            res = engine.submit([Experiment.of(b) for b in blocks],
                                kernel_lock=kernel_lock)
            return [c.cycles for c in res]

    def predict_batch(self, blocks, on_error: str = "raise") -> list:
        """Predictions for many blocks in one pass.

        ``on_error="raise"`` raises :class:`UnknownInstructionError` for the
        first block referencing uncharacterized instructions;
        ``on_error="return"`` yields the exception object in that block's
        slot instead (the service's per-request structured errors).

        Traced as a ``predict.batch`` span (inheriting the serving
        request's ``trace_id`` when reached from a traced server
        thread)."""
        codes = [list(b) for b in blocks]
        with obs.span("predict.batch", blocks=len(codes)):
            return self._predict_batch(codes, on_error)

    def _predict_batch(self, codes, on_error: str) -> list:
        errors: dict[int, UnknownInstructionError] = {}
        for i, code in enumerate(codes):
            try:
                check_block(self.model, code, self.isa)
            except UnknownInstructionError as e:
                if on_error == "raise":
                    raise
                errors[i] = e
        valid = [i for i in range(len(codes)) if i not in errors]
        # summed usage per block, in code order (reference semantics)
        sums = {i: sum_usage(self.model, codes[i]) for i in valid}
        port_bounds = self._port_bounds(sums)
        out: list = [None] * len(codes)
        for i in valid:
            usage_sum, uops = sums[i]
            fe = uops / self.issue_width
            lat = _latency_bound(self.model, self.isa, codes[i])
            pb = port_bounds[i]
            cycles = max(pb, lat, fe)
            out[i] = Prediction(cycles, pb, lat, fe,
                                port_pressure(usage_sum),
                                classify_bottleneck(cycles, pb, lat))
        for i, e in errors.items():
            out[i] = e
        return out

    # ------------------------------------------------------------------
    def _port_bounds(self, sums: dict) -> dict:
        """Port bound per block index: one matrix pass over the dense usage
        rows where the closed form applies, LP fallback elsewhere."""
        bounds: dict[int, float] = {}
        if not sums:
            return bounds
        idxs = sorted(sums)
        fast_rows: list[int] = []
        for i in idxs:
            usage_sum, _ = sums[i]
            distinct = sum(1 for n in usage_sum.values() if n > 0)
            if distinct == 0:
                bounds[i] = 0.0
            elif distinct > CUT_COMBO_CAP or self._cut_mask is None:
                # same rule + same insertion-ordered dict as the reference
                bounds[i] = port_bound_from_usage(usage_sum)
            else:
                fast_rows.append(i)
        if fast_rows:
            best = None
            if (self.backend != "numpy"
                    and len(fast_rows) >= self.min_device_blocks):
                best = self._device_bounds(sums, fast_rows)
            if best is None:
                self._stats["numpy_waves"] += 1
                u = np.zeros((len(fast_rows), len(self._combos)))
                for r, i in enumerate(fast_rows):
                    for pc, n in sums[i][0].items():
                        u[r, self._combo_idx[pc]] = n
                demand = u @ self._cut_mask          # rows × candidates
                ratios = demand / self._cut_size
                best = ratios.max(axis=1)
            for r, i in enumerate(fast_rows):
                bounds[i] = float(best[r])
        return bounds

    # ------------------------------------------------------------------
    # device-resident closed form (torch and cuda backends)
    # ------------------------------------------------------------------
    def _device_bounds(self, sums: dict, fast_rows: list):
        """All fast-row port bounds in one device call, or None to route
        the wave to numpy (non-integer counts, overflow risk).

        The kernel is exact: int32 ``demand = u @ mask`` then an integer
        cross-multiplication argmax over candidates; the single float64
        division happens host-side, so results are bit-identical to the
        scalar reference."""
        n = len(fast_rows)
        u = np.zeros((n, len(self._combos)), dtype=np.int32)
        for r, i in enumerate(fast_rows):
            for pc, cnt in sums[i][0].items():
                v = int(cnt)
                if v != cnt:                    # non-integer μop count
                    self._stats["device_fallbacks"] += 1
                    return None
                u[r, self._combo_idx[pc]] = v
        # cross products stay well inside int32: demand ≤ row total
        if int(u.sum(axis=1).max()) * int(self._size_i.max()) >= 2 ** 31:
            self._stats["device_fallbacks"] += 1
            return None
        num, den = self._device_call(u)
        self._stats["device_waves"] += 1
        self._stats["device_blocks"] += n
        return num.astype(np.float64) / den.astype(np.float64)

    def _device_call(self, u: np.ndarray):
        """``(num, den)`` of every row of ``u`` as host int32 arrays: one
        launch of exactly ``len(u)`` rows on this call's own tensors, its
        ``(2, len(u))`` result copied to the host once before it returns
        (worker threads share the predictor)."""
        mask_d, size_d = self._device_tables()
        u_d = torch.from_numpy(u).to(self.device)
        out = port_bound.port_bound(u_d, mask_d, size_d)
        if self.launched_args is not None:
            self.launched_args.append((u_d, mask_d, size_d))
        num, den = out.cpu().numpy()
        return num, den

    def _device_tables(self):
        """The candidate mask and sizes on the device, uploaded once per
        predictor (with the kernel's library loaded, on a card)."""
        if self._dev_mask is not None:
            return self._dev_mask, self._dev_size
        with self._dev_lock:
            if self._dev_mask is None:
                with obs.span("predict.compile", backend=self.backend):
                    if self.device.type == "cuda":
                        port_bound.LIBRARY.load()
                    mask = torch.from_numpy(self._mask_i).to(self.device)
                    self._dev_size = torch.from_numpy(self._size_i).to(
                        self.device)
                    self._dev_mask = mask    # set last: the unlocked check
                self._stats["device_compiles"] += 1
            return self._dev_mask, self._dev_size

    def backend_stats(self) -> dict:
        """Counters for the vectorized closed-form backend (wave counts,
        device compiles/fallbacks) — absorbed into service metrics."""
        return {"backend": self.backend, **self._stats}
