"""Plain float32 references of the model families the configurations use."""
