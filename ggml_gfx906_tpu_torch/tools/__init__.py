"""Developer tools of the port: the op-conformance harness (backend_ops)."""
