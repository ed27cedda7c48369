"""Request-mesh runtime: shard-ordered sums and multi-process serving."""
