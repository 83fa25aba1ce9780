"""Parallelism of the port: the serving half of the logical-axis
sharding rules and the collectives the sharded model needs (DESIGN.md
§10).  Training's FSDP rules, the pipeline and gradient compression are
not ported yet."""
