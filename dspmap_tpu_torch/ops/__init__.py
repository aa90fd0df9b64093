"""Per-stage operations of the map step (one module per JAX counterpart)."""
