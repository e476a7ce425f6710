"""Device resolution."""
