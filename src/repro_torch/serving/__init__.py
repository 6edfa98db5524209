"""Serving: the paged continuous-batching decode engine (port of
``repro.serving``)."""
