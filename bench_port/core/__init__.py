"""The harness: cells from their files, seeded data, work counts, tracing, the import guard."""
