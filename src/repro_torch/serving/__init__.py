"""The serving window pass, its guard and the streaming driver."""
