"""SE(3) geometry."""
