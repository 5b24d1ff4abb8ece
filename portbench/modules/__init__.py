"""Configuration modules: what one kind of configuration sets up, feeds,
calls, compares and counts (``lpips.py`` is the default; see the
README)."""
