"""Homa-SRPT serving scheduler (the port of ``repro.serving``)."""
