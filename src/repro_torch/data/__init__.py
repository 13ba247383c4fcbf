"""Synthetic event-stream tasks (a numpy copy of ``repro.data.events``)."""
