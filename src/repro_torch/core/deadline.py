"""Aliases for the latency-control plane (counterpart of
``repro.core.deadline``): the deadline -> budget controller and the
calibrated latency model live in ``repro_torch.control``; ``LatencyModel``
is its :class:`AffinePredictor`."""
from repro_torch.control.policy import BudgetController
from repro_torch.control.predictors import AffinePredictor as LatencyModel

__all__ = ["BudgetController", "LatencyModel"]
