"""Neural building blocks."""
