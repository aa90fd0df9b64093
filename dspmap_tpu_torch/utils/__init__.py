"""Host-side utilities: synthetic scene simulation, markers and PLY
exports, profiling, and the stage and kernel timers of the card."""
