"""The port's configuration for its lint (counterpart of
``repro/analysis/config.py``, written for ``src/repro_torch``).

* ``SCAN_DIRS`` — the port's package only: the call graph matches names,
  so a reference module in the scan would join the port's hot set by name.
* ``HOT_PATH_ROOTS`` — the port's block loop; every function reachable
  from it through the (name-matched, over-approximate) call graph is "hot"
  for SPL001.
* ``ALLOWLIST`` — ``(path, scope, rule) -> max_count`` budgets for the
  sanctioned device-to-host copies. A budget is a count: a second copy in
  ``InferenceEngine.step`` fires although the first is sanctioned. Budgets
  stay in lock-step with the ``sproutlint: allow(SPL001)`` anchor comments
  at the sanctioned sites.
* ``DETERMINISTIC_PATHS`` — module prefixes whose behavior feeds traces,
  PRNG streams or plan state; SPL003's wall-clock and stdlib-random checks
  apply only there.
"""
from __future__ import annotations

SCAN_DIRS = ("src/repro_torch",)

# The block loop's root for SPL001 reachability. Format: "path::scope".
HOT_PATH_ROOTS = (
    "src/repro_torch/serving/engine.py::InferenceEngine.step",
)

# (repo-relative path, scope, rule) -> max sanctioned findings.
ALLOWLIST = {
    # The one device-to-host copy per block: tokens, emitted mask, live
    # mask and finiteness verdict, read together after the block's replay.
    ("src/repro_torch/serving/engine.py", "InferenceEngine.step", "SPL001"): 1,
    # A whole-prompt prefill group's first tokens, read in one copy.
    ("src/repro_torch/serving/engine.py", "InferenceEngine._prefill_group",
     "SPL001"): 1,
}

DETERMINISTIC_PATHS = (
    "src/repro_torch/core",
    "src/repro_torch/serving",
    "src/repro_torch/models",
    "src/repro_torch/kernels",
)
