"""Experiment scripts of the port (run on the card with ``python -m``)."""
