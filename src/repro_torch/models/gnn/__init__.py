"""GNN models: SchNet (continuous-filter convolutions) + neighbor sampler."""
