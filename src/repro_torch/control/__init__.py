"""The latency-control plane (port of the parts of ``repro.control`` the
serving loop, the engine and the simulator use)."""
from repro_torch.control.policy import (CONTRACTS, POLICIES, BudgetController,
                                        DeadlineBudgetPolicy)
from repro_torch.control.predictors import (AffinePredictor, EwmaPredictor,
                                            QuantilePredictor, TailTracker,
                                            make_predictor, percentile)

__all__ = ["CONTRACTS", "POLICIES", "BudgetController",
           "DeadlineBudgetPolicy", "AffinePredictor", "EwmaPredictor",
           "QuantilePredictor", "TailTracker", "make_predictor",
           "percentile"]
