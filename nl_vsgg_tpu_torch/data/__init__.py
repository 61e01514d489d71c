"""The Entry contract, the taxonomy, synthetic fixtures and the host data
engine (Action Genome readers, grounding, prefetching, caches, the device
Entry store)."""
