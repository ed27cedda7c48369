"""Streamed request world and the GeneratedSource request source."""
