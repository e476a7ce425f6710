"""Eval step (the train step is not ported yet)."""
