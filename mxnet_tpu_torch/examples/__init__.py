"""Runnable examples of the port (≙ the repo's ``example/`` scripts)."""
