"""The latency-control plane (port of the parts of ``repro.control`` the
serving loop, the engine, the scatter-gather tier and the simulator use):
the predictors, the deadline -> budget policy and its serving contracts,
the per-component budget allocation and gather modes, the recovery
ladder, the online accuracy estimator, the queue-aware admission
policy and the fleet autoscaler."""
from repro_torch.control.admission import (AdmissionConfig, AdmissionPolicy,
                                           SLOClass, TokenBucket,
                                           parse_slo_classes)
from repro_torch.control.autoscaler import (Autoscaler, AutoscalerConfig,
                                            FleetSize, drain)
from repro_torch.control.estimator import (AccuracyEstimator,
                                           calibration_pairs,
                                           coverage_profile, isotonic_fit,
                                           spearman)
from repro_torch.control.policy import (CONTRACTS, MODE_DROP, MODE_FULL,
                                        MODE_STAGE1, POLICIES,
                                        BudgetController,
                                        DeadlineBudgetPolicy, allocate_budget)
from repro_torch.control.predictors import (AffinePredictor, EwmaPredictor,
                                            QuantilePredictor, TailTracker,
                                            make_predictor, percentile)
from repro_torch.control.recovery import (RetryPolicy, plan_recovery,
                                          realized_recovery)

__all__ = ["CONTRACTS", "MODE_DROP", "MODE_FULL", "MODE_STAGE1", "POLICIES",
           "BudgetController", "DeadlineBudgetPolicy", "allocate_budget",
           "RetryPolicy", "plan_recovery", "realized_recovery", "AccuracyEstimator", "calibration_pairs",
           "coverage_profile", "isotonic_fit", "spearman",
           "AffinePredictor", "EwmaPredictor", "QuantilePredictor",
           "TailTracker", "make_predictor", "percentile",
           "AdmissionConfig", "AdmissionPolicy", "SLOClass", "TokenBucket",
           "parse_slo_classes", "Autoscaler", "AutoscalerConfig",
           "FleetSize", "drain"]
