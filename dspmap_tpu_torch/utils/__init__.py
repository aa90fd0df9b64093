"""Host-side utilities: synthetic scene simulation, markers and PLY
exports, profiling, the stage and kernel timers of the card, and the
comparison of a card step with a CPU step (``parity``)."""
