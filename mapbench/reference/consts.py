"""The frozen constants and mapper knobs the plain reference needs, copied
from ``gnumap_tpu_torch/config.py`` (the fixed-point scales, the sentinel,
the window, band and retention rules).  The reference imports nothing of
the program: a change there cannot move this yardstick."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PWM_SCALE = 1 << 12
S_SCALE = 1 << 6
SCORE_ONE = PWM_SCALE * S_SCALE
WINDOW_ALIGN = 8
RATIO_BITS = 32
NEG_INF = -(1 << 29)
BASE_N = 4
N_BASES = 4
SPACER_N = 64


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The knobs of ``MapperConfig`` that change a mapping, with its
    defaults; built from a configuration file's ``mapper`` group."""
    mer_size: int = 10
    seed_jump: int = 5
    max_hits_per_seed: int = 64
    max_candidates: int = 128
    match_score: float = 1.0
    mismatch_score: float = -1.0
    gap_open: float = 4.0
    gap_extend: float = 1.0
    gap_slack: int = 8
    align_score_ratio: float = 0.9
    max_read_len: int = 160

    @classmethod
    def from_mapper(cls, mapper: dict) -> "RefConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in mapper.items() if k in names})

    def gap_open_q(self) -> int:
        return int(round(self.gap_open * SCORE_ONE))

    def gap_extend_q(self) -> int:
        return int(round(self.gap_extend * SCORE_ONE))

    def window_width(self) -> int:
        return self.max_read_len + 2 * self.gap_slack + WINDOW_ALIGN

    def window_start(self, cand):
        return ((cand - self.gap_slack) // WINDOW_ALIGN) * WINDOW_ALIGN

    def band(self) -> Optional[Tuple[int, int]]:
        bw = 4 * self.gap_slack + WINDOW_ALIGN + 2
        if bw <= 64:
            return (self.gap_slack + 1, bw)
        return None

    def ratio_q(self) -> int:
        return int(round(self.align_score_ratio * (1 << RATIO_BITS)))

    def threshold_for(self, max_score: int) -> int:
        aq = self.ratio_q()
        return (aq * int(max_score) + (1 << RATIO_BITS) - 1) >> RATIO_BITS
