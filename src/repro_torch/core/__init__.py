"""CLOVER decomposition, pruning and PEFT of the port (DESIGN.md §2,
§3)."""
