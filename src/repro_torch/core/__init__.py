"""CLOVER decomposition and pruning of the port (DESIGN.md §2, §3)."""
