"""Solvers in the probe → prepare → run protocol."""
