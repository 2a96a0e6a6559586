"""Engine front end."""
