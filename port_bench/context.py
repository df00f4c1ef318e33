"""What a per-layer metric reader (metrics/<name>.py, `read(ctx)` → a
number or None) is given: the run's loop record, the traced slice's
summary, the eager prefill calls, and the model's sizes and products."""
from __future__ import annotations

from dataclasses import dataclass

from . import roofline


@dataclass
class Context:
    res: object            # driver.LoopResult
    trace: object          # trace.Summary of the traced slice
    prefills: list         # (host time, "chunk" | "flood", token tensor)
    hp: dict               # the configuration's published sizes
    ref: object            # ref/<arch>.py: matrices, products, active_params, sizes
    n_layer: int

    @property
    def window_s(self) -> float:
        return self.res.t_close - self.res.t_open

    def harvests_in(self, t0: float, t1: float) -> list:
        """Harvested windows (t_end, seconds, tokens) that end in [t0, t1]."""
        return [h for h in self.res.harvests if t0 <= h[0] <= t1]

    def completed(self) -> list:
        return [d for d in self.res.done if self.res.t_open <= d.t_finish <= self.res.t_close]

    def prefill_rows(self, t0: float, t1: float) -> list[int]:
        """Real rows (non-pad tokens) of each eager prefill called in [t0, t1]."""
        return [int((tok != 0).sum()) for t, _, tok in self.prefills if t0 <= t <= t1]

    def experts_per_token(self) -> int:
        return int(self.hp.get("num_experts_per_tok", 0))

    def least_s(self, T: float) -> float:
        return roofline.forward_least_s(self.ref.products(self.hp), T, self.experts_per_token())
