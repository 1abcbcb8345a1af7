"""Runnable entry points beside the library (counterpart of ``examples/``)."""
