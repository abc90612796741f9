"""The reference the benchmark holds the program to (imports nothing of it)."""
