from keystone_tpu_torch.evaluation.evaluators import (  # noqa: F401
    AugmentedExamplesEvaluator,
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
    MeanAveragePrecisionEvaluator,
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)
