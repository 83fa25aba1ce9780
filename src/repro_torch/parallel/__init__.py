"""Parallelism of the port: the logical-axis sharding rules of serving
and training and the autograd-aware collectives the sharded model needs
(``sharding``, DESIGN.md §10), int8 gradients across pods
(``compress``) and the GPipe pipeline (``pipeline``)."""
