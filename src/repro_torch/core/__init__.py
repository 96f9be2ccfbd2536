"""SPROUT core: generation directives, carbon-aware LP optimizer,
opportunistic offline quality evaluation, and the serving controller.

Public API:
    DirectiveSet, Directive          — paper Def. 1 / §III-E
    solve_directive_lp               — Eq. 2–7 optimizer
    EvaluationInvoker                — Eq. 8 opportunistic assessment
    QualityEvaluator                 — N-way AlpacaEval-style judge
    SproutSimulation, summarize      — end-to-end evaluation harness
    EnergyModel, CarbonIntensityProvider, request_carbon
"""
from repro_torch.core.carbon import (CarbonIntensityProvider, REGIONS, SEASONS,
                                     WatchdogProvider, carbon_intensity_trace,
                                     request_carbon, PUE)
from repro_torch.core.grid_client import GridSignalClient
from repro_torch.core.controller import (SproutSimulation, SchemeStats,
                                         summarize)
from repro_torch.core.directives import (DEFAULT_DIRECTIVES, Directive,
                                         DirectiveSet)
from repro_torch.core.energy import (A100_40GB, H100_SXM_80GB, TPU_V5E,
                                     LLAMA2_7B, LLAMA2_13B, EnergyModel,
                                     HardwareSpec, ModelProfile)
from repro_torch.core.invoker import EvaluationInvoker
from repro_torch.core.lp import (BATCH, DEFAULT_TENANTS, PREMIUM, STANDARD,
                                 DirectiveSolution, TenantSpec,
                                 quality_lower_bound, solve_directive_lp,
                                 solve_tenant_lps)
from repro_torch.core.quality import EvaluationReport, QualityEvaluator
from repro_torch.core.workload import TASKS, Request, Workload

__all__ = [
    "CarbonIntensityProvider", "WatchdogProvider", "GridSignalClient",
    "REGIONS", "SEASONS", "carbon_intensity_trace",
    "request_carbon", "PUE", "SproutSimulation", "SchemeStats", "summarize",
    "DEFAULT_DIRECTIVES", "Directive", "DirectiveSet", "A100_40GB",
    "H100_SXM_80GB", "TPU_V5E",
    "LLAMA2_7B", "LLAMA2_13B", "EnergyModel", "HardwareSpec", "ModelProfile",
    "EvaluationInvoker", "DirectiveSolution", "quality_lower_bound",
    "solve_directive_lp", "solve_tenant_lps", "TenantSpec", "PREMIUM",
    "STANDARD", "BATCH", "DEFAULT_TENANTS", "EvaluationReport",
    "QualityEvaluator", "TASKS", "Request", "Workload",
]
