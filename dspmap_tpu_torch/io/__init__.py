"""IO: checkpointing, particle CSV export, frame replay, rosbag ingestion."""

from .checkpoint import save_state, load_state  # noqa: F401
from .particles_csv import export_particles_csv  # noqa: F401
