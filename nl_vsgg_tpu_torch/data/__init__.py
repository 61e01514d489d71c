"""Entry contract, taxonomy and synthetic fixtures."""
