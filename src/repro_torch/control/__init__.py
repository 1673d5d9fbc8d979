"""The latency-control plane of the serving loop (port of the parts of
``repro.control`` the loop uses)."""
from repro_torch.control.policy import BudgetController
from repro_torch.control.predictors import AffinePredictor, make_predictor

__all__ = ["AffinePredictor", "BudgetController", "make_predictor"]
