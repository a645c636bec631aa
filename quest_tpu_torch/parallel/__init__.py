"""Sharding: the amplitude mesh, its topology and the exchange layer."""
