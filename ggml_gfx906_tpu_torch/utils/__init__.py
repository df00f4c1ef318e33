"""Configuration registry and device choice."""
