"""Dispatch (`ops`) and device selection (`device`)."""
