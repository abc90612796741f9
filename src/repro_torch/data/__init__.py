"""Synthetic graphs and workloads (numpy)."""
