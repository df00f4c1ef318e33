"""Examples of the port (the counterpart of the repo's examples/)."""
