"""parallel subpackage of the port (mirrors repro.parallel)."""
