"""Continuous-batching serving (counterpart of ``repro.serve``)."""
