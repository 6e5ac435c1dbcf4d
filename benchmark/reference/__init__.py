"""Plain float32 references of what the benchmark runs, one module per model kind."""
