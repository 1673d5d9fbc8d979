"""Arrival traces and the discrete-event scatter-gather simulator (the
port's own numpy-only copies of ``repro.serving``)."""
