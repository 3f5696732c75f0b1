"""serve subpackage of the port (mirrors repro.serve)."""
