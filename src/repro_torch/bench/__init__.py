from repro_torch.bench.harness import LatencyStats, latency_stats  # noqa: F401
