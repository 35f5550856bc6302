"""Traffic drivers, one a kind."""
