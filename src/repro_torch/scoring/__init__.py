"""The decoupled forward-only scoring engine."""
from repro_torch.scoring.engine import ScoreEngine

__all__ = ["ScoreEngine"]
