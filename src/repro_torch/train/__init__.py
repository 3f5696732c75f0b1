"""train subpackage of the port (mirrors repro.train)."""
