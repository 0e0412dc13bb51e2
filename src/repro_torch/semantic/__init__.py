"""Semantic tier: temporal frame signatures (the gate waits for its slice)."""
