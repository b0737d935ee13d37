"""Launchers (serving)."""
