"""The benchmark's plain references: :mod:`.dsp`, one frame of the map in
plain NumPy written from its semantics, and :mod:`.step`, which computes a
compared frame with it in the pool layout (and the control, in a lower
precision); :mod:`.compact`, the same for the compact layout's rows, on
:mod:`.dsp`'s layout-free stages.  A configuration file names its
reference under ``reference`` (``step`` where it names none).  Nothing
here imports the program under test."""
