from veneur_tpu_torch.samplers.metrics import (  # noqa: F401
    AGGREGATES_LOOKUP,
    Aggregate,
    HistogramAggregates,
    InterMetric,
    MetricKey,
    MetricScope,
    MetricType,
    UDPMetric,
)
from veneur_tpu_torch.samplers.parser import Parser  # noqa: F401
