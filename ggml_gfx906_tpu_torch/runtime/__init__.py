"""KV caches, sampling and the continuous-batching engine."""
