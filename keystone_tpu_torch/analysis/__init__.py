"""Pre-flight static analysis of workflow pipelines (counterpart of
``keystone_tpu/analysis``).

The reference's headline property, statically type-safe pipelines,
rebuilt as an ahead-of-fit analyzer: abstract shape and dtype
interpretation over the workflow graph on fake tensors (no device work),
a precision lint over the solvers' contractions, a lint of the
robustness configuration (fault plans, breakers, deadlines), the CSE and
cache-signature audit (with the cross-pipeline sharing plan's collision
gate), and the installed physical plan's audit.  Typed findings; wired
into ``Pipeline.fit(validate=)`` / ``KEYSTONE_VALIDATE=1``,
``Pipeline.freeze(validate=)`` and ``python -m keystone_tpu_torch.cli
check``.
"""

from keystone_tpu_torch.analysis.analyzer import (  # noqa: F401
    ALL_PASSES,
    DEFAULT_PASSES,
    ENV_VALIDATE,
    analyze,
    validate_fit,
    validate_freeze,
    validation_enabled,
)
from keystone_tpu_torch.analysis.bundled import BUNDLED, build_bundled  # noqa: F401
from keystone_tpu_torch.analysis.findings import (  # noqa: F401
    AnalysisReport,
    Finding,
    PipelineValidationError,
)
from keystone_tpu_torch.analysis.precision import MODES, SOLVER_ENTRIES, check_fn  # noqa: F401
