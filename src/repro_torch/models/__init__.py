"""Layers, embedding bags and the cascade's stage models."""
