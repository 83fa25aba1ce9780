"""Data of the port: the synthetic token stream with savable state."""
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM  # noqa: F401
