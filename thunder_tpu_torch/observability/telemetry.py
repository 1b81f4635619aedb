"""Live telemetry, limited to what the SLO monitors read.

thunder_tpu/observability/telemetry.py for the port: only ``percentile``,
the nearest-rank convention shared by the SLO monitors (slo.py) and the
bench harnesses. The streaming histograms, gauges and the Prometheus
exporter wait for the rest of the observability slice (ROADMAP A6).
"""
from __future__ import annotations


def percentile(xs, q: float):
    """Nearest-rank percentile over a concrete sample list: the sorted
    sample at index round(q · (n - 1)); 0.0 for no samples."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]
