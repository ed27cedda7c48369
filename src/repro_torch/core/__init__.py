"""Chain set, FLOPs counts, reward model and the single-price allocator."""
