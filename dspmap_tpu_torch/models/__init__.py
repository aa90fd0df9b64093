"""The per-frame step and its readouts."""
