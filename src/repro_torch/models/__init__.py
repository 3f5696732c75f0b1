"""models subpackage of the port (mirrors repro.models)."""
