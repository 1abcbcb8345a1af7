"""Headless frontends over the solvers."""
