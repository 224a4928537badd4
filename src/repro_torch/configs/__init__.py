"""Model and workload configurations."""
