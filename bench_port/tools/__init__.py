"""Tools of the benchmark that its runs do not call."""
