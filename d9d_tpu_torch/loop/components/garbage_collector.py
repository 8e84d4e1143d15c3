"""Manual garbage collection (counterpart of
``d9d_tpu/loop/components/garbage_collector.py``): automatic GC makes step
times jittery, so it is disabled inside the loop and run every N steps."""

import gc


class ManualGarbageCollector:
    def __init__(self, every_steps: int | None = 100):
        self.every_steps = every_steps
        self._was_enabled = False

    def __enter__(self):
        if self.every_steps is not None:
            self._was_enabled = gc.isenabled()
            gc.disable()
            gc.collect()
        return self

    def __exit__(self, *exc):
        if self.every_steps is not None and self._was_enabled:
            gc.enable()
        return False

    def step(self, step: int) -> None:
        if self.every_steps is not None and step % self.every_steps == 0:
            gc.collect()
