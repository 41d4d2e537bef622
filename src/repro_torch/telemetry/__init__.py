"""SLO telemetry subsystem: metrics registry, ring-buffer time series,
Prometheus/JSONL exporters, serving-stack instruments, and the
attainment-driven autoscaler.  Dependency-free by design (see
registry.py); zero overhead when ``REPRO_METRICS`` is off."""
from repro_torch.telemetry.autoscaler import (Autoscaler, AutoscalerConfig,
                                              ScaleDecision)
from repro_torch.telemetry.exporters import (StepTracer, histogram_percentiles,
                                             parse_prometheus, prometheus_text,
                                             quantile_from_exposition,
                                             timeseries_prometheus_text)
from repro_torch.telemetry.instruments import (ClusterTelemetry, PlanTimer,
                                               ReplicaTelemetry, slo_class_of)
from repro_torch.telemetry.registry import (LATENCY_BUCKETS, Counter, Gauge,
                                            Histogram, MetricsRegistry,
                                            metrics_enabled)
from repro_torch.telemetry.timeseries import RingBuffer, TimeSeriesSampler
