"""The metric readers: port_bench/metrics/<metric name>.py, each with
read(rec) -> float or None."""
