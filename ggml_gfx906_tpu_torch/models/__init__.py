"""Models of the port (llama)."""
