"""SE(3) and camera geometry."""
