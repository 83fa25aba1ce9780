"""Data of the port: the synthetic token stream with savable state, and
this rank's rows of a global batch."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticConfig, SyntheticLM, make_global_batch)
