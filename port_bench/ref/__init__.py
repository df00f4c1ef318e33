"""Plain PyTorch references of the benchmark's model configurations: float32,
no kernels, no cache, no batching; each imports torch and the benchmark's
own `quant` module only, never the port and never JAX."""
