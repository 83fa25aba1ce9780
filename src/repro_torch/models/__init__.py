"""Model zoo of the port: ``layers`` and the config-driven decoder
``transformer`` (DESIGN.md §1)."""
