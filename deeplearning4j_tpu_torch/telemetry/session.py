"""Counterpart of ``deeplearning4j_tpu/telemetry/session.py``:
``TrainTelemetry``, the host side of the in-step metrics loop.

A metrics-threaded train step returns a dict of DEVICE scalars each step.
Reading them one by one would synchronise host and card every step;
``TrainTelemetry`` keeps the tensors and moves the whole window to the
host in ONE transfer every ``interval`` steps (every tensor flattened into
one float64 buffer on its device, then one ``.cpu()``), then fans the
values out to:

- the JSONL step-event log (``telemetry/step_log.py``): ts, step, wall_ms,
  tokens/s, every metric;
- the MetricsRegistry: gauges (loss/grad_norm/param_norm/update_ratio,
  per-expert ``router_load{expert=...}``), the ``train_steps_total``
  counter and the ``train_step_ms`` histogram.

``record()`` between interval edges never synchronises with the device.
``static`` metadata is stamped on every log line and exported as a
``<prefix>_run_info`` info-gauge.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.telemetry.step_log import StepLogWriter

DEFAULT_INTERVAL = 10


def _fetch(window: List[Dict]) -> List[Dict]:
    """The window's metric dicts with every tensor as its host value
    (``tolist()``: Python numbers, lists for vectors), moved in one
    transfer. float64 holds every f32, bf16 and int32 value exactly; each
    value comes back in its own dtype."""
    tensors = [v for m in window for v in m.values()
               if isinstance(v, torch.Tensor)]
    host: List = []
    if tensors:
        dev = tensors[0].device
        flat = torch.cat([t.detach().reshape(-1).to(device=dev,
                                                    dtype=torch.float64)
                          for t in tensors]).cpu()
        at = 0
        for t in tensors:
            n = t.numel()
            host.append(flat[at:at + n].reshape(t.shape).to(t.dtype)
                        .tolist())
            at += n
    it = iter(host)
    return [{k: (next(it) if isinstance(v, torch.Tensor)
                 else v.tolist() if hasattr(v, "tolist") else v)
             for k, v in m.items()} for m in window]


class TrainTelemetry:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 step_log_path: Optional[str] = None,
                 interval: int = DEFAULT_INTERVAL,
                 tokens_per_step: Optional[int] = None,
                 static: Optional[Dict] = None,
                 prefix: str = "train"):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.interval = max(1, int(interval))
        self.tokens_per_step = tokens_per_step
        self.prefix = prefix
        self.static = dict(static or {})
        self._writer = (StepLogWriter(step_log_path, static=self.static)
                        if step_log_path else None)
        self._buf = []  # (step, wall_ms, device metrics): no host sync
        self._last_t: Optional[float] = None
        self.steps_recorded = 0
        self.records = []  # fetched records (host values), for callers
        if self.static:
            self.registry.gauge(
                f"{prefix}_run_info",
                labels={k: str(v) for k, v in self.static.items()}).set(1)

    # ---- hot path ----
    def record(self, step: int, metrics) -> None:
        """Keep one step's device metrics; transfers only at interval
        edges."""
        now = time.perf_counter()
        wall_ms = (None if self._last_t is None
                   else (now - self._last_t) * 1000.0)
        self._last_t = now
        self._buf.append((step, wall_ms, metrics))
        self.steps_recorded += 1
        if len(self._buf) >= self.interval:
            self.flush()

    # ---- the one device->host transfer per window ----
    def flush(self) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        fetched = _fetch([m for _, _, m in buf])
        for (step, wall_ms, _), host in zip(buf, fetched):
            tps = None
            if wall_ms and self.tokens_per_step:
                tps = self.tokens_per_step / (wall_ms / 1000.0)
            self._export(step, wall_ms, tps, host)

    def _export(self, step, wall_ms, tps, host: Dict) -> None:
        reg, p = self.registry, self.prefix
        reg.counter(f"{p}_steps_total").inc()
        reg.gauge(f"{p}_step").set(step)
        for k, v in host.items():
            if isinstance(v, (list, tuple)):
                for i, vi in enumerate(v):
                    reg.gauge(f"{p}_{k}", labels={"expert": str(i)}
                              if k == "router_load" else
                              {"index": str(i)}).set(float(vi))
            elif isinstance(v, (int, float)):
                reg.gauge(f"{p}_{k}").set(float(v))
        if wall_ms is not None:
            reg.histogram(f"{p}_step_ms").observe(wall_ms)
        if tps is not None:
            reg.gauge(f"{p}_tokens_per_sec").set(tps)
        rec = None
        if self._writer:
            rec = self._writer.write(step, wall_ms=wall_ms,
                                     tokens_per_sec=tps, **host)
        if rec is None:
            rec = {"step": step, "wall_ms": wall_ms,
                   "tokens_per_sec": tps, **host}
        self.records.append(rec)

    def close(self) -> None:
        self.flush()
        if self._writer:
            self._writer.close()

    def __enter__(self) -> "TrainTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
