"""Config, metrics, device choice and weight conversion."""
