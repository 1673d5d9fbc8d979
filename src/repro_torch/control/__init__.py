"""The latency-control plane (port of the parts of ``repro.control`` the
serving loop, the engine and the simulator use): the predictors, the
deadline -> budget policy and its serving contracts, the online accuracy
estimator and the queue-aware admission policy."""
from repro_torch.control.admission import (AdmissionConfig, AdmissionPolicy,
                                           SLOClass, TokenBucket,
                                           parse_slo_classes)
from repro_torch.control.estimator import (AccuracyEstimator,
                                           calibration_pairs,
                                           coverage_profile, isotonic_fit,
                                           spearman)
from repro_torch.control.policy import (CONTRACTS, POLICIES, BudgetController,
                                        DeadlineBudgetPolicy)
from repro_torch.control.predictors import (AffinePredictor, EwmaPredictor,
                                            QuantilePredictor, TailTracker,
                                            make_predictor, percentile)

__all__ = ["CONTRACTS", "POLICIES", "BudgetController",
           "DeadlineBudgetPolicy", "AccuracyEstimator", "calibration_pairs",
           "coverage_profile", "isotonic_fit", "spearman",
           "AffinePredictor", "EwmaPredictor", "QuantilePredictor",
           "TailTracker", "make_predictor", "percentile",
           "AdmissionConfig", "AdmissionPolicy", "SLOClass", "TokenBucket",
           "parse_slo_classes"]
