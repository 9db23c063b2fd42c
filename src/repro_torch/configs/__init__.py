"""Architecture configs of the port (those the slices so far run)."""
