"""Steps over batched Entries (eval only so far)."""
