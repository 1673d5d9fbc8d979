"""AccuracyTrader core: synopsis management + accuracy-aware processing
(counterpart of ``repro.core``)."""
from repro_torch.core import cluster, deadline, engine, synopsis
from repro_torch.core.deadline import BudgetController, LatencyModel
from repro_torch.core.engine import (ProcessResult, approximate_process,
                                     exact_process)
from repro_torch.core.synopsis import (Synopsis, build, insert, needs_rebuild,
                                       update_changed)

__all__ = [
    "cluster", "deadline", "engine", "synopsis",
    "BudgetController", "LatencyModel",
    "ProcessResult", "approximate_process", "exact_process",
    "Synopsis", "build", "insert", "needs_rebuild", "update_changed",
]
