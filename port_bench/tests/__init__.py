"""Tests of the benchmark: python3 -m pytest -q -p no:cacheprovider
port_bench/tests."""
