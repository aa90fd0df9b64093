"""The benchmark's plain reference: :mod:`.dsp`, one frame of the map in
plain NumPy written from its semantics, and :mod:`.step`, which computes a
compared frame with it (and the control, in a lower precision).  Nothing
here imports the program under test."""
