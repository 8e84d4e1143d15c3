"""Device-buffered metric collection for the training loop (counterpart of
``d9d_tpu/loop/components/metric_collector.py``).

Raw task statistics (the ``task/*`` entries of a step's metric dict)
accumulate as device tensors between log steps — additions enqueued without
a host wait; only :meth:`flush` on the log cadence copies them to the host,
feeds the task's metric objects, computes them and pushes the results to
the tracker run. A task with no metric objects costs nothing here.
"""

import numpy as np
import torch

TASK_STAT_PREFIX = "task/"


def _flatten_result(name: str, value) -> dict[str, float]:
    out: dict[str, float] = {}
    if isinstance(value, dict):
        for k, v in value.items():
            out.update(_flatten_result(f"{name}/{k}", v))
        return out
    arr = np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value)
    if arr.ndim == 0:
        out[name] = float(arr)
    else:
        for i, v in enumerate(arr.reshape(-1)):
            out[f"{name}/{i}"] = float(v)
    return out


class MetricCollector:
    def __init__(self, task):
        self.task = task
        self.metrics = task.metrics()
        self._carry: dict[str, torch.Tensor] | None = None

    def collect(self, step_metrics: dict) -> None:
        """Accumulate this step's raw task statistics on the device."""
        if not self.metrics:
            return
        stats = {k[len(TASK_STAT_PREFIX):]: v for k, v in step_metrics.items()
                 if k.startswith(TASK_STAT_PREFIX)}
        if not stats:
            return
        if self._carry is None:
            self._carry = {k: v.clone() for k, v in stats.items()}
        else:
            for k, v in stats.items():
                self._carry[k] += v

    def flush(self, run, step: int) -> dict[str, float]:
        """Materialize the window's statistics, update/sync/compute every
        task metric, push to the tracker, reset for the next window."""
        if not self.metrics or self._carry is None:
            return {}
        host_stats = {k: v.cpu().numpy() for k, v in self._carry.items()}
        self._carry = None
        self.task.update_metrics(self.metrics, host_stats)
        results: dict[str, float] = {}
        for name, metric in self.metrics.items():
            metric.sync()
            results.update(_flatten_result(name, metric.compute()))
            metric.reset()
        if run is not None:
            for k, v in results.items():
                run.track_scalar(f"metric/{k}", v, step=step,
                                 context={"subset": "train"})
        return results
