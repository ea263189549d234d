"""Drivers: one per kind of configuration, named by its ``driver`` key."""
