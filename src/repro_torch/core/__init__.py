"""core subpackage of the port (mirrors repro.core)."""
