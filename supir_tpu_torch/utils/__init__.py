"""Weight bridge and colour fix."""
