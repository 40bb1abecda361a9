"""Tools: freon's load generators and benchmarks (tools/freon.py)."""
