"""Host-side utilities: step timing, the history JSON, device traces."""
