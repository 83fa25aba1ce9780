"""CLOVER decomposition, pruning and PEFT of the port (DESIGN.md §2,
§3, §13)."""
from repro_torch.core.peft import (  # noqa: F401
    SV_ADAPTER_KEYS, AdapterRegistry, sv_extract, sv_fold)
