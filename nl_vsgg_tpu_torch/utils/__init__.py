"""Host utilities of the port (numpy only)."""
