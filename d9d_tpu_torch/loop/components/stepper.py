"""Step counting (counterpart of ``d9d_tpu/loop/components/stepper.py``
``Stepper``; its ``StepActionPeriod`` is not ported)."""

import dataclasses


@dataclasses.dataclass
class Stepper:
    total_steps: int | None = None
    step: int = 0

    def advance(self) -> int:
        self.step += 1
        return self.step

    @property
    def finished(self) -> bool:
        return self.total_steps is not None and self.step >= self.total_steps

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
